"""Host ms a step inside the port's `deepxi.train.step` span (model step
layer: the whole of `training.make_train_step`'s step, example synthesis,
forward, backward and update)."""

from perfbench.harness.spans import host_ms_per


def read(ctx):
    return host_ms_per(ctx, "deepxi.train.step", ctx.work["steps"])
