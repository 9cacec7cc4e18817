"""All the work of the window's completed calls over the window: the
command's unit of work (``Job.work``) per call, times the calls, over the
time from the window's start to the end of its last call."""


def read(ctx):
    return ctx.window.rate(ctx.job.work)
