"""Device ms a fine step in its backward (K5, K6 and the projection's
autograd): the device time in the program's `fine.step.backward` span, over
the traced call's steps."""


def read(trace):
    ms = trace.stage_ms.get("fine.step.backward")
    steps = trace.info.get("fine_steps")
    return ms / steps if ms is not None and steps else None
