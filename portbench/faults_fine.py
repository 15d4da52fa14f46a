"""Faults planted in the program's fine stage, each a context manager that
breaks one part of `register_gs_pair(fine=True)` underneath while inside:
the readings that a broken timed path gives set the upper ends of the fine
cell's limits (PERF.md), and the CPU tests show each makes a run not
correct. Never used by a benchmark run."""

from __future__ import annotations

from portbench.faults import _patched


def pairs_dropped():
    """Every render with a saturation cull (the fine loop's steps and
    probes) keeps only the first 99 % of its sorted pairs, rounded down to a
    128-pair block, and counts the rest as dropped at the pair capacity."""
    import torch

    from gaussreg_tpu_torch.gs.rasterizer import render

    def make(orig):
        def cut(*args, **kwargs):
            b = orig(*args, **kwargs)
            if kwargs.get("sat_depth") is None:
                return b
            cap = max(128, int(0.99 * int(b.num_pairs)) // 128 * 128)
            if cap >= b.sorted_gid.shape[0]:
                return b
            dropped = torch.clamp_min(b.num_pairs - cap, 0).to(torch.int32)
            return b._replace(sorted_gid=b.sorted_gid[:cap].contiguous(),
                              overflow_cap=b.overflow_cap + dropped)
        return cut

    return _patched(render, "bin_gaussians", make)


def sh_rotation_skipped():
    """The similarity moves the gaussians but leaves their SH bands 1-3
    unrotated."""
    from gaussreg_tpu_torch.gs import sh

    return _patched(sh, "rotate_sh_rest", lambda orig: lambda f_rest, rotation: f_rest)


def colour_off():
    """Every projected colour 1 % too large (targets and moved model
    alike)."""
    from gaussreg_tpu_torch.gs.rasterizer import render

    def make(orig):
        def off(*args, **kwargs):
            proj = orig(*args, **kwargs)
            return proj._replace(colors=proj.colors * 1.01)
        return off

    return _patched(render, "project_gaussians", make)


def sat_margin_one():
    """The fine loop's saturation cull without its margin: sat_margin 1.0 in
    place of 1.10."""
    from gaussreg_tpu_torch.gs import fine_registration

    def make(orig):
        def no_margin(*args, **kwargs):
            if "sat_margin" in kwargs:
                kwargs["sat_margin"] = 1.0
            return orig(*args, **kwargs)
        return no_margin

    return _patched(fine_registration, "render", make)


FAULTS = {
    "pairs_dropped": pairs_dropped,
    "sh_rotation_skipped": sh_rotation_skipped,
    "colour_off": colour_off,
    "sat_margin_one": sat_margin_one,
}
