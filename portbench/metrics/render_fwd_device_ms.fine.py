"""Device ms a fine step in its forward renders (gs/rasterizer/project.py,
binning.py, K4 in kernels.py, and the loss): the device time in the
program's `fine.step.forward` span, over the traced call's steps."""


def read(trace):
    ms = trace.stage_ms.get("fine.step.forward")
    steps = trace.info.get("fine_steps")
    return ms / steps if ms is not None and steps else None
