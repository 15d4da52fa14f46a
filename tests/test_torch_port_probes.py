"""The two TPU probes' twins (gaussreg_tpu_torch/tools/probe_vmem_gather.py,
P1, and probe_kernels_r5.py, P2) on the CPU: their plain versions against
the Pallas probes run interpreted.

- P1: every plain gather equals table[idx] and the probe's `kernel`, and
  the bodies of `kernel2` and `kernel3` (nested in the probe's main(), so
  rebuilt here from the same formulas), bit for bit.
- P2: `make_blocks` draws the probe's arrays; each plain core equals
  probe_kernels_r5.run_fwd (interpreted) at make_blocks(3, 2): kend equal,
  rgb and T within 5e-6 for A, C and D (f32 sums in another order: a
  cumulative sum or product where the probe takes a matrix product), and
  within 5e-4 for B, whose bf16 rounding of lg can land on the other
  neighbour where the two log1p differ in the last bit (one bf16 step of
  lg, at most 2^-8 |lg| <= 2e-4 here, moves the later weights of its pixel).
  The same holds on ragged ranges whose tiles saturate and exit early,
  and on tiles of which only one half saturates (the kernel splits a tile
  over a cluster of blocks, each owning a half, which must agree on kend).

The blocks built here are shared with the card tests
(tests/test_torch_port_cuda.py), so this module imports no JAX at the top.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from gaussreg_tpu_torch.tools import probe_kernels_r5 as p2
from gaussreg_tpu_torch.tools import probe_vmem_gather as p1

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P2_LIMITS = {"A": 5e-6, "B": 5e-4, "C": 5e-6, "D": 5e-6}


def _jax_probe(name):
    """The JAX probe script tools/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ragged_saturating_blocks():
    """Blocks whose tiles saturate (opacity x 40, alpha capped at 0.99), so
    tiles exit before their last chunk, over ragged ranges: tile 0 starts
    inside block 0, tile 1 is empty, tile 2 shares block 2 with tile 3 and
    tile 4 starts past the last block (clamped to the cap, empty)."""
    blocks, _, _ = p2.make_blocks(num_tiles=4, blocks_per_tile=2, seed=3)
    blocks[:, 0] += np.float32(np.log(40.0))
    starts = np.array([37, 300, 300, 330, 1030, 1100], np.int32)
    return blocks, starts, 5


def _band(blocks, b, j, cx, cy):
    """Pair j of block b as a gaussian stretched along x (sigma_x 1 000,
    sigma_y 1): raw >= 1 within 7.5 rows of cy, under 1/255 from 8.5 rows
    on (power 28.5 - (y - cy)^2 / 2)."""
    a, c = 1e-6, 1.0
    blocks[b, 0, j] = 28.5 - 0.5 * (a * cx * cx + c * cy * cy)
    blocks[b, 1, j], blocks[b, 2, j] = a * cx, c * cy
    blocks[b, 3, j], blocks[b, 4, j], blocks[b, 5, j] = -0.5 * a, 0.0, -0.5 * c


def half_saturating_blocks():
    """Four tiles of four low-opacity blocks, three of them with pairs that
    saturate one half of the tile's rows (0-15 or 16-31, the halves of a
    cluster of two blocks) and leave the other untouched: tile 0's top half
    falls below T = 1e-4 after chunk 2, its bottom after chunk 3 (kend 3);
    tile 1's top after chunk 1 and its bottom never (kend 4); tile 2 the
    other way round from tile 0; tile 3 as drawn (kend 4)."""
    blocks, starts, _ = p2.make_blocks(num_tiles=4, blocks_per_tile=4, seed=4)
    for t, top, bottom in ((0, 1, 2), (1, 0, None), (2, 2, 1)):
        for blk, cy in ((top, 8.0), (bottom, 24.0)):
            if blk is not None:
                for j in (40, 41, 42):  # three pairs at alpha 0.99: T x 1e-6
                    _band(blocks, 4 * t + blk, j, 32.0 * t + 16.0, cy)
    return blocks, starts, 4


@pytest.fixture(scope="module")
def jax_probes():
    return _jax_probe("probe_vmem_gather"), _jax_probe("probe_kernels_r5")


def _jax_gathers(probe, table, idx):
    """The probe's three kernels, interpreted on the CPU: `kernel` with the
    table in pltpu.ANY, and `kernel2` / `kernel3` as main() defines them."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    g, c = table.shape
    k = idx.shape[0]

    def kernel2(idx_ref, table_ref, out_ref):
        out_ref[...] = jnp.take(table_ref[...], idx_ref[0], axis=0)

    def kernel3(idxv_ref, table_ref, out_ref):
        idxv = idxv_ref[...]
        gids = jax.lax.broadcasted_iota(jnp.int32, (k, g), 1)
        onehot = (gids == idxv.reshape(k, 1)).astype(jnp.float32)
        out_ref[...] = jax.lax.dot_general(
            onehot, table_ref[...], dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )

    shape = jax.ShapeDtypeStruct((k, c), jnp.float32)
    t, i = jnp.asarray(table), jnp.asarray(idx[None])
    specs = {
        "global": (probe.kernel, [pl.BlockSpec(memory_space=pltpu.SMEM),
                                  pl.BlockSpec(memory_space=pltpu.ANY)]),
        "shared": (kernel2, [pl.BlockSpec(memory_space=pltpu.SMEM),
                             pl.BlockSpec((g, c), memory_space=pltpu.VMEM)]),
        "onehot": (kernel3, [pl.BlockSpec((1, k), memory_space=pltpu.VMEM),
                             pl.BlockSpec((g, c), memory_space=pltpu.VMEM)]),
    }
    return {name: np.asarray(pl.pallas_call(fn, out_shape=shape, in_specs=sp,
                                            interpret=True)(i, t))
            for name, (fn, sp) in specs.items()}


def test_gather_plain_versions_match_the_pallas_probe(jax_probes):
    table, idx = p1.make_inputs(0, device="cpu")
    ref = table.numpy()[idx.numpy()]
    jax_out = _jax_gathers(jax_probes[0], table.numpy(), idx.numpy())
    for variant in p1.PLAIN:
        out = p1.gather(variant, table, idx).numpy()  # the CPU tensor takes the plain version
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(p1.PLAIN[variant](table, idx).numpy(), ref)
        for name, o in jax_out.items():
            np.testing.assert_array_equal(o, ref, err_msg=f"Pallas {name}")


def test_gather_rejects_bad_input():
    table, idx = p1.make_inputs(0, g=64, k=5, device="cpu")
    with pytest.raises(ValueError, match="table"):
        p1.gather("global", table[:, :4], idx)
    with pytest.raises(ValueError, match="table"):
        p1.gather("shared", table, idx[None])


def test_make_blocks_draws_the_probes_arrays(jax_probes):
    blocks, starts, g = p2.make_blocks(num_tiles=3, blocks_per_tile=2, seed=1)
    jb, js, jg = jax_probes[1].make_blocks(num_tiles=3, blocks_per_tile=2, seed=1)
    np.testing.assert_array_equal(blocks, np.asarray(jb))
    np.testing.assert_array_equal(starts, np.asarray(js))
    assert g == jg


def _check_core(out, ref, variant):
    np.testing.assert_array_equal(out[:, 5], ref[:, 5])  # kend
    diff = np.abs(out[:, :5] - ref[:, :5]).max()
    assert diff <= P2_LIMITS[variant], f"core {variant}: {diff}"


@pytest.mark.parametrize("variant", p2.CORES)
def test_composite_plain_matches_the_pallas_probe(jax_probes, variant):
    blocks, starts, _ = p2.make_blocks(num_tiles=3, blocks_per_tile=2)
    ref = np.asarray(jax_probes[1].run_fwd(blocks, starts, variant, 3, 32, 32))
    out = p2.run_fwd(torch.from_numpy(blocks), torch.from_numpy(starts), variant, 3).numpy()
    assert (out[:, 5, 0] == 2).all()  # low opacity: every block walked
    _check_core(out, ref, variant)


@pytest.mark.parametrize("variant", p2.CORES)
def test_composite_plain_exits_as_the_pallas_probe(jax_probes, variant):
    blocks, starts, tiles = ragged_saturating_blocks()
    ref = np.asarray(jax_probes[1].run_fwd(blocks, starts, variant, tiles, 32, 32))
    out = p2.run_fwd(torch.from_numpy(blocks), torch.from_numpy(starts), variant, tiles).numpy()
    kend = out[:, 5, 0]
    assert kend[1] == 0 and kend[4] == 0  # empty tiles
    assert kend[0] < 3 and kend[3] < 6  # early exits
    assert (out[[1, 4], 4] == 1.0).all() and (out[[1, 4], :4] == 0.0).all()
    _check_core(out, ref, variant)


@pytest.mark.parametrize("variant", p2.CORES)
def test_composite_plain_exits_on_half_saturated_tiles(jax_probes, variant):
    blocks, starts, tiles = half_saturating_blocks()
    ref = np.asarray(jax_probes[1].run_fwd(blocks, starts, variant, tiles, 32, 32))
    out = p2.run_fwd(torch.from_numpy(blocks), torch.from_numpy(starts), variant, tiles).numpy()
    assert (out[:, 5, 0] == [3, 4, 3, 4]).all()
    t = out[:, 4].reshape(tiles, 32, 32)
    assert t[1, :16].max() < p2.T_EPS <= t[1, 16:].max()  # one half left, the other not
    assert t[[0, 2]].max() < p2.T_EPS
    _check_core(out, ref, variant)


def test_composite_pair_count_and_bound_inputs():
    blocks, starts, _ = p2.make_blocks(num_tiles=2, blocks_per_tile=3)
    out = p2.run_fwd(torch.from_numpy(blocks), torch.from_numpy(starts), "D", 2)
    pp = 2 * 3 * 128 * 1024
    assert p2.pair_pixels(out, torch.from_numpy(starts)) == pp
    assert p2.walked_blocks(torch.from_numpy(starts), out[:, 5, 0], blocks.shape[0]) == 6
    # the special-function unit sets A-C's bound, the f32 operations D's
    for core, by in (("A", "transcendentals"), ("C", "transcendentals"), ("D", "f32 operations")):
        b_ms, b_of, parts = p2.bound(out, torch.from_numpy(starts), blocks.shape[0], core, 132,
                                     1980.0)
        assert b_of == by and b_ms == parts[by] == max(parts.values())
        assert parts["transcendentals"] == pytest.approx(
            pp * p2.TRANSCENDENTALS_PER_PAIR_PIXEL[core] / (16 * 132 * 1980e6) * 1e3)
        assert parts["f32 operations"] == pytest.approx(
            pp * p2.OPS_PER_PAIR_PIXEL[core] / 67e12 * 1e3)
        assert parts["bytes"] == pytest.approx((6 * 16 * 128 + 3 + 2 * 6 * 1024) * 4 / 3.35e9)
    with pytest.raises(ValueError, match="core"):
        p2.run_fwd(torch.from_numpy(blocks), torch.from_numpy(starts), "E", 2)
    with pytest.raises(ValueError, match="starts"):
        p2.run_fwd(torch.from_numpy(blocks), torch.from_numpy(starts), "A", 3)


def test_cluster_copy_changes_only_the_cluster_size(tmp_path):
    """The cluster sweep's copies differ from the shipped source in kCluster
    alone, and bind the same entry points."""
    kernels = p2.cluster_copy(4, str(tmp_path))
    with open(p2.KERNELS["A"].source) as f:
        shipped = f.read().splitlines()
    with open(kernels["A"].source) as f:
        copy = f.read().splitlines()
    diff = [(a, b) for a, b in zip(shipped, copy) if a != b]
    assert len(copy) == len(shipped) and len(diff) == 1
    assert diff[0][0].startswith(f"constexpr int kCluster = {p2.CLUSTER};")
    assert diff[0][1].startswith("constexpr int kCluster = 4;")
    assert {c: (k.symbol, k.argtypes) for c, k in kernels.items()} == {
        c: (k.symbol, k.argtypes) for c, k in p2.KERNELS.items()}
