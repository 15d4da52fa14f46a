"""Device ms a fine step (gs/fine_registration.py, the rasterizer, Adam): the
device time in the program's `fine.step` span and its `fine.step.forward`,
`.backward` and `.adam` spans, over the traced call's steps (the counter
`fine.steps`, redone steps included)."""

STAGES = ("fine.step", "fine.step.forward", "fine.step.backward", "fine.step.adam")


def read(trace):
    hits = [trace.stage_ms[s] for s in STAGES if s in trace.stage_ms]
    steps = trace.info.get("fine_steps")
    return sum(hits) / steps if hits and steps else None
