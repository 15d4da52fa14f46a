"""Import reference (PyTorch) GaussReg checkpoints into the port's model
(port of gaussreg_tpu/engine/torch_import.py).

The reference distributes pretrained weights as torch snapshots
(reference README.md:115-124) saved by `engine/base_trainer.py:112-137`:
a dict with a 'model' state-dict (optionally 'module.'-prefixed under DDP,
stripped on save / re-added on load at base_trainer.py:139-165). The
mapping rules below take those keys to the JAX package's parameter tree
(its layout, kept here as the port's own copy), and
`engine/checkpoint.params_from_flax` takes that tree to the port model's
state_dict, the same route the port's msgpack checkpoints take.

Conventions:
- torch nn.Linear weight is (out, in): flax Dense kernel = weight.T.
- torch GroupNorm/LayerNorm weight -> flax `scale`.
- KPConv weights are (K, in, out) on both sides; the torch `kernel_points`
  buffer (randomly rotated at instantiation, reference
  kernel_points.py:428-453) is imported into the `kernel_points` param so
  influences match bit-for-bit.
- the RPE attention applies proj_p on the q side (math-identical rewrite,
  models/transformer.py): kernel = proj_p.weight.T, same as a Dense.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from gaussreg_tpu_torch.config import REFERENCE_NEIGHBOR_LIMITS, CapacityConfig, Config
from gaussreg_tpu_torch.engine.checkpoint import (
    _ENCODER_BLOCKS,  # the residual blocks in the order of the flax tree
    flax_from_params,
    params_from_flax,
)

_IDENT = lambda x: x
_T = lambda x: np.ascontiguousarray(np.swapaxes(x, -1, -2))


def _linear(torch_prefix: str, flax_path: tuple) -> list:
    return [
        (f"{torch_prefix}.weight", flax_path + ("kernel",), _T),
        (f"{torch_prefix}.bias", flax_path + ("bias",), _IDENT),
    ]


def _groupnorm(torch_prefix: str, flax_path: tuple) -> list:
    # reference wraps nn.GroupNorm as `.norm` inside its GroupNorm module
    # (reference modules.py:33-50)
    return [
        (f"{torch_prefix}.norm.weight", flax_path + ("scale",), _IDENT),
        (f"{torch_prefix}.norm.bias", flax_path + ("bias",), _IDENT),
    ]


def _layernorm(torch_prefix: str, flax_path: tuple) -> list:
    return [
        (f"{torch_prefix}.weight", flax_path + ("scale",), _IDENT),
        (f"{torch_prefix}.bias", flax_path + ("bias",), _IDENT),
    ]


def _unary(torch_prefix: str, flax_path: tuple) -> list:
    # UnaryBlock: .mlp Linear + .norm GroupNorm (reference modules.py:53-83)
    return _linear(f"{torch_prefix}.mlp", flax_path + ("Dense_0",)) + _groupnorm(
        f"{torch_prefix}.norm", flax_path + ("MaskedGroupNorm_0",)
    )


def _kpconv(torch_prefix: str, flax_path: tuple) -> list:
    return [
        (f"{torch_prefix}.weights", flax_path + ("weights",), _IDENT),
        (f"{torch_prefix}.bias", flax_path + ("bias",), _IDENT),
        (f"{torch_prefix}.kernel_points", flax_path + ("kernel_points",), _IDENT),
    ]


def _residual_block(torch_prefix: str, flax_path: tuple, has_shortcut: bool) -> list:
    # reference modules.py:149-225: unary1 / KPConv / norm_conv / unary2 /
    # unary_shortcut <-> UnaryBlock_0 / KPConv_0 / MaskedGroupNorm_0 /
    # UnaryBlock_1 / UnaryBlock_2 of the JAX package's ResidualBlock
    rules = _unary(f"{torch_prefix}.unary1", flax_path + ("UnaryBlock_0",))
    rules += _kpconv(f"{torch_prefix}.KPConv", flax_path + ("KPConv_0",))
    rules += _groupnorm(
        f"{torch_prefix}.norm_conv", flax_path + ("MaskedGroupNorm_0",)
    )
    rules += _unary(f"{torch_prefix}.unary2", flax_path + ("UnaryBlock_1",))
    if has_shortcut:
        rules += _unary(
            f"{torch_prefix}.unary_shortcut", flax_path + ("UnaryBlock_2",)
        )
    return rules


def _attention_layer(torch_prefix: str, flax_path: tuple, rpe: bool) -> list:
    # (RPE)TransformerLayer: .attention(.attention MHA, .linear, .norm) +
    # .output AttentionOutput(.expand, .squeeze, .norm)
    # (reference rpe_transformer.py:75-131, vanilla_transformer.py:73-129,
    # output_layer.py:6-21)
    mha = "RPEMultiHeadAttention_0" if rpe else "MultiHeadAttention_0"
    at = f"{torch_prefix}.attention.attention"
    rules = []
    for p in ("proj_q", "proj_k", "proj_v"):
        rules += _linear(f"{at}.{p}", flax_path + (mha, p))
    if rpe:
        rules += [
            (f"{at}.proj_p.weight", flax_path + (mha, "proj_p_kernel"), _T),
            (f"{at}.proj_p.bias", flax_path + (mha, "proj_p_bias"), _IDENT),
        ]
    rules += _linear(f"{torch_prefix}.attention.linear", flax_path + ("Dense_0",))
    rules += _layernorm(
        f"{torch_prefix}.attention.norm", flax_path + ("LayerNorm_0",)
    )
    out = flax_path + ("AttentionOutput_0",)
    rules += _linear(f"{torch_prefix}.output.expand", out + ("Dense_0",))
    rules += _linear(f"{torch_prefix}.output.squeeze", out + ("Dense_1",))
    rules += _layernorm(f"{torch_prefix}.output.norm", out + ("LayerNorm_0",))
    return rules


def mapping_rules(blocks: Tuple[str, ...] = ("self", "cross") * 3) -> list:
    """All (torch_key, flax_path, transform) rules for the GaussReg model
    (reference experiments/.../model.py:19-67 composition)."""
    rules: List[tuple] = []

    # --- backbone (reference backbone.py:98-163)
    bb = ("params", "backbone")
    rules += _kpconv("backbone.encoder1_1.KPConv", bb + ("ConvBlock_0", "KPConv_0"))
    rules += _groupnorm(
        "backbone.encoder1_1.norm", bb + ("ConvBlock_0", "MaskedGroupNorm_0")
    )
    for i, name in enumerate(_ENCODER_BLOCKS):
        # unary_shortcut exists iff in_channels != out_channels — i.e. every
        # non-strided block; the strided stage entries keep in == out
        has_shortcut = not name.endswith("_1") or name == "encoder1_2"
        rules += _residual_block(
            f"backbone.{name}", bb + (f"CheckpointResidualBlock_{i}",), has_shortcut
        )
    rules += _unary("backbone.decoder4", bb + ("UnaryBlock_0",))
    rules += _unary("backbone.decoder3", bb + ("UnaryBlock_1",))
    rules += _linear("backbone.decoder2.mlp", bb + ("Dense_0",))

    # --- geometric transformer (reference geotransformer.py:75-155)
    tr = ("params", "transformer")
    rules += _linear("transformer.embedding.proj_d", tr + ("embedding", "proj_d"))
    rules += [
        (
            "transformer.embedding.proj_a.weight",
            tr + ("embedding", "proj_a_kernel"),
            _T,
        ),
        (
            "transformer.embedding.proj_a.bias",
            tr + ("embedding", "proj_a_bias"),
            _IDENT,
        ),
    ]
    rules += _linear("transformer.in_proj", tr + ("in_proj",))
    rules += _linear("transformer.out_proj", tr + ("out_proj",))
    for i, kind in enumerate(blocks):
        rules += _attention_layer(
            f"transformer.transformer.layers.{i}",
            tr + ("transformer", f"layer_{i}_{kind}"),
            rpe=(kind == "self"),
        )

    # --- optimal transport dustbin (reference learnable_sinkhorn.py:10)
    rules += [("optimal_transport.alpha", ("params", "ot_alpha"), _IDENT)]
    return rules


def _flatten(tree, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat: Dict[tuple, np.ndarray]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def convert_state_dict(state_dict: Dict[str, np.ndarray], flax_params: dict):
    """Map a reference torch state dict onto a parameter tree in the JAX
    package's layout ({"params": ...}; `model_params_tree` gives the port
    model's).

    Returns (params, report) where report lists `missing` flax paths (kept
    at their current values), `unexpected` torch keys, and `converted`
    count. Mirrors the reference's logged key diff
    (base_trainer.py:144-160) instead of failing hard; a shape mismatch
    raises ValueError.
    """
    state_dict = {
        (k[7:] if k.startswith("module.") else k): np.asarray(v)
        for k, v in state_dict.items()
    }
    flat = dict(_flatten(flax_params))
    converted, unexpected = 0, []
    used_torch, filled = set(), set()
    for torch_key, flax_path, tf in mapping_rules():
        if torch_key not in state_dict:
            continue
        if flax_path not in flat:
            unexpected.append(torch_key)
            continue
        v = tf(state_dict[torch_key]).astype(np.float32)
        if v.shape != tuple(flat[flax_path].shape):
            raise ValueError(
                f"{torch_key} -> {'/'.join(flax_path)}: shape {v.shape} "
                f"!= {tuple(flat[flax_path].shape)}"
            )
        flat[flax_path] = v.astype(flat[flax_path].dtype)
        used_torch.add(torch_key)
        filled.add(flax_path)
        converted += 1
    missing = sorted("/".join(p) for p in set(flat) - filled)
    unexpected += sorted(set(state_dict) - used_torch)
    # reference checkpoints carry a random per-layer rotation of the kernel
    # disposition (kernel_points.py:428-453), so the shared-geometry fast
    # path (models/backbone.py, shared_geometry) is numerically WRONG for
    # them. Detect it here so callers build the model with
    # cfg.backbone.shared_kpconv_geometry == False before using the params.
    kp = [v for p, v in flat.items() if p and p[-1] == "kernel_points"]
    per_layer_geometry = bool(kp) and any(
        not np.allclose(k, kp[0], atol=1e-6) for k in kp[1:]
    )
    report = {
        "converted": converted,
        "missing": missing,
        "unexpected": unexpected,
        # True -> build the model with shared_kpconv_geometry=False
        "per_layer_kernel_geometry": per_layer_geometry,
    }
    return _unflatten(flat), report


def model_params_tree(model: torch.nn.Module) -> dict:
    """The model's weights as {"params": tree} in the JAX package's layout,
    the template `convert_state_dict` fills."""
    return {"params": flax_from_params(model.state_dict())}


def load_torch_snapshot(path: str, flax_params: dict):
    """Load a reference .pth.tar snapshot (on the CPU) and convert it."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    model_dict = state.get("model", state)
    model_dict = {k: np.asarray(v.numpy() if torch.is_tensor(v) else v)
                  for k, v in model_dict.items()}
    return convert_state_dict(model_dict, flax_params)


def pin_reference_neighbor_limits(cfg: Config) -> Config:
    """Swap synthetic-calibrated default neighbor limits for the reference's
    published ScanNet-GSReg calibration (89, 30, 43, 49, 49) (reference
    test.py:129) on full-capacity configs. Imported released weights must
    see the truncation statistics they were trained with; tiny-capacity
    configs (levels[0] < 4096) and explicitly overridden limits are left
    untouched."""
    default_limits = CapacityConfig().neighbor_limits
    if (
        cfg.capacity.neighbor_limits == default_limits
        and cfg.capacity.levels[0] >= 4096
    ):
        cfg = dataclasses.replace(
            cfg,
            capacity=dataclasses.replace(
                cfg.capacity, neighbor_limits=REFERENCE_NEIGHBOR_LIMITS
            ),
        )
    return cfg


def load_for_inference(path: str, cfg: Config, model):
    """Load a reference torch snapshot into the port's model for the
    inference CLIs.

    Reference checkpoints carry a random per-layer kernel rotation
    (kernel_points.py:428-453): when detected, the model is rebuilt (on the
    same device) with `shared_kpconv_geometry=False`, so every KPConv
    evaluates its own imported disposition (the shared fast path would be
    numerically wrong). Neighbor limits are pinned to the reference's
    published calibration (`pin_reference_neighbor_limits`).
    Returns (cfg, model, report); the model holds the imported weights.
    """
    from gaussreg_tpu_torch.models.registration import create_model

    cfg = pin_reference_neighbor_limits(cfg)
    params, report = load_torch_snapshot(path, model_params_tree(model))
    if report["per_layer_kernel_geometry"] and cfg.backbone.shared_kpconv_geometry:
        cfg = dataclasses.replace(
            cfg,
            backbone=dataclasses.replace(
                cfg.backbone, shared_kpconv_geometry=False
            ),
        )
        model = create_model(cfg, next(model.parameters()).device)
    model.load_state_dict(params_from_flax(params["params"]))
    return cfg, model, report


def fake_reference_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    """A randomly-initialized state dict with the reference's exact keys and
    shapes (for tests: torch checkpoints aren't distributable here)."""
    rng = np.random.default_rng(seed)
    d = {}

    def lin(prefix, cin, cout):
        d[f"{prefix}.weight"] = rng.normal(size=(cout, cin)).astype(np.float32)
        d[f"{prefix}.bias"] = rng.normal(size=(cout,)).astype(np.float32)

    def gn(prefix, c):
        d[f"{prefix}.norm.weight"] = rng.normal(size=(c,)).astype(np.float32)
        d[f"{prefix}.norm.bias"] = rng.normal(size=(c,)).astype(np.float32)

    def ln(prefix, c):
        d[f"{prefix}.weight"] = rng.normal(size=(c,)).astype(np.float32)
        d[f"{prefix}.bias"] = rng.normal(size=(c,)).astype(np.float32)

    def kpc(prefix, cin, cout, k=15):
        d[f"{prefix}.weights"] = rng.normal(size=(k, cin, cout)).astype(np.float32)
        d[f"{prefix}.bias"] = rng.normal(size=(cout,)).astype(np.float32)
        d[f"{prefix}.kernel_points"] = rng.normal(size=(k, 3)).astype(np.float32)

    def unary(prefix, cin, cout):
        lin(f"{prefix}.mlp", cin, cout)
        gn(f"{prefix}.norm", cout)

    def res(prefix, cin, cout):
        mid = cout // 4
        unary(f"{prefix}.unary1", cin, mid)
        kpc(f"{prefix}.KPConv", mid, mid)
        gn(f"{prefix}.norm_conv", mid)
        unary(f"{prefix}.unary2", mid, cout)
        if cin != cout:
            unary(f"{prefix}.unary_shortcut", cin, cout)

    # backbone channel plan (reference backbone.py:98-163, init_dim 64)
    kpc("backbone.encoder1_1.KPConv", 4, 64)
    gn("backbone.encoder1_1.norm", 64)
    chans = {
        "encoder1_2": (64, 128),
        "encoder2_1": (128, 128), "encoder2_2": (128, 256), "encoder2_3": (256, 256),
        "encoder3_1": (256, 256), "encoder3_2": (256, 512), "encoder3_3": (512, 512),
        "encoder4_1": (512, 512), "encoder4_2": (512, 1024), "encoder4_3": (1024, 1024),
        "encoder5_1": (1024, 1024), "encoder5_2": (1024, 2048), "encoder5_3": (2048, 2048),
    }
    for name, (cin, cout) in chans.items():
        res(f"backbone.{name}", cin, cout)
    unary("backbone.decoder4", 64 * 48, 1024)
    unary("backbone.decoder3", 64 * 24, 512)
    lin("backbone.decoder2.mlp", 64 * 12, 256)

    # transformer (hidden 256)
    lin("transformer.embedding.proj_d", 256, 256)
    lin("transformer.embedding.proj_a", 256, 256)
    lin("transformer.in_proj", 2048, 256)
    lin("transformer.out_proj", 256, 256)
    for i in range(6):
        at = f"transformer.transformer.layers.{i}.attention"
        for p in ("proj_q", "proj_k", "proj_v"):
            lin(f"{at}.attention.{p}", 256, 256)
        if i % 2 == 0:  # self layers are RPE
            lin(f"{at}.attention.proj_p", 256, 256)
        lin(f"{at}.linear", 256, 256)
        ln(f"{at}.norm", 256)
        out = f"transformer.transformer.layers.{i}.output"
        lin(f"{out}.expand", 256, 512)
        lin(f"{out}.squeeze", 512, 256)
        ln(f"{out}.norm", 256)

    d["optimal_transport.alpha"] = np.asarray(1.3, np.float32)
    return d
