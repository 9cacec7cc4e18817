"""Process start to the first timed call: imports, the card, the kernel
libraries (built into the checkout on its first run), the inputs from
the seed, the command's set-up and one warm-up call."""


def read(ctx):
    return ctx.setup_s
