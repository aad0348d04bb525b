"""Device ms a step of the optimizer's multi-tensor kernels
(`training.ClipAdam` and the parameters' update), found by name."""

from perfbench.harness.readers import device_ms_per


def read(ctx):
    return device_ms_per(ctx, ("multi_tensor_apply",), ctx.work["steps"])
