"""``engine.count_file`` of each genome inside the measured calls (the
port's ``engine.count_file`` spans) in the traced window: the mean, in
ms."""

from h100bench.harness import spans


def read(ctx):
    view = spans.of(ctx)
    files = [] if view is None else view.named("engine.count_file")
    if not files:
        return None
    return 1000 * view.total_s("engine.count_file") / len(files)
