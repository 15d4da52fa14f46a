"""Weights carried across from the JAX package.

`read_flax_msgpack` decodes a flax msgpack checkpoint (such as
checkpoints/synthetic_coarse.msgpack) with a small msgpack decoder of its
own, so neither `msgpack` nor `flax` is needed. `params_from_flax` maps the
JAX package's parameter tree (nested dicts of numpy arrays) to the port
model's state_dict:

- flax Dense kernels (in, out) become torch Linear weights (out, in);
- KPConv `weights` (K, Cin, Cout) and `kernel_points` keep the JAX layout,
  as does the RPE attention's `proj_p_kernel`;
- GroupNorm / LayerNorm `scale` becomes `weight`;
- `ot_alpha` maps to the model's `ot_alpha`.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

# flax/serialization.py _MsgpackExtType
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """A minimal msgpack decoder: maps, arrays, str, bin, ints, floats,
    nil, bool and ext (flax ndarray / numpy scalar)."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def _uint(self, n: int) -> int:
        return int.from_bytes(self._take(n), "big")

    def read(self) -> Any:
        b = self._uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return bytes(self._take(b & 0x1F)).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self._take(self._uint(1 << (b - 0xC4))))
        if b in (0xC7, 0xC8, 0xC9):
            n = self._uint(1 << (b - 0xC7))
            return self._ext(self._uint(1), n)
        if b == 0xCA:
            return struct.unpack(">f", self._take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self._take(8))[0]
        if 0xCC <= b <= 0xCF:
            return self._uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:
            n = 1 << (b - 0xD0)
            return int.from_bytes(self._take(n), "big", signed=True)
        if 0xD4 <= b <= 0xD8:
            code = self._uint(1)
            return self._ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return bytes(self._take(self._uint(1 << (b - 0xD9)))).decode("utf-8")
        if b in (0xDC, 0xDD):
            return self._array(self._uint(2 if b == 0xDC else 4))
        if b in (0xDE, 0xDF):
            return self._map(self._uint(2 if b == 0xDE else 4))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _array(self, n: int) -> List:
        return [self.read() for _ in range(n)]

    def _ext(self, code: int, n: int) -> Any:
        data = bytes(self._take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype_name, buffer = _Reader(data).read()
            if isinstance(dtype_name, bytes):
                dtype_name = dtype_name.decode()
            arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape).copy()
            return arr[()] if code == _EXT_NPSCALAR else arr
        raise ValueError(f"unsupported msgpack ext type {code}")


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def read_flax_msgpack(path: str) -> Dict[str, Any]:
    """Decode a flax msgpack file into nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    return _unchunk(tree)


# ---------------------------------------------------------------- mapping


def _dense(tree, prefix: str, sd: Dict[str, np.ndarray]) -> None:
    sd[f"{prefix}.weight"] = np.asarray(tree["kernel"]).T
    sd[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _norm(tree, prefix: str, sd) -> None:
    sd[f"{prefix}.weight"] = np.asarray(tree["scale"])
    sd[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _unary(tree, prefix: str, sd) -> None:
    _dense(tree["Dense_0"], f"{prefix}.linear", sd)
    _norm(tree["MaskedGroupNorm_0"], f"{prefix}.norm", sd)


def _kpconv(tree, prefix: str, sd) -> None:
    for name in ("weights", "kernel_points", "bias"):
        sd[f"{prefix}.{name}"] = np.asarray(tree[name])


def _residual(tree, prefix: str, sd) -> None:
    _kpconv(tree["KPConv_0"], f"{prefix}.conv", sd)
    _norm(tree["MaskedGroupNorm_0"], f"{prefix}.norm", sd)
    unaries = sorted(k for k in tree if k.startswith("UnaryBlock_"))
    mid = np.asarray(tree["KPConv_0"]["weights"]).shape[1]
    # flax numbers the unary blocks in creation order: [unary1 if
    # in != mid], unary2, [shortcut if in != out]
    if len(unaries) == 3:
        names = ["unary1", "unary2", "unary_shortcut"]
    elif len(unaries) == 2:
        first_out = np.asarray(tree["UnaryBlock_0"]["Dense_0"]["kernel"]).shape[1]
        names = ["unary1", "unary2"] if first_out == mid else ["unary2", "unary_shortcut"]
    else:
        names = ["unary2"]
    for flax_name, name in zip(unaries, names):
        _unary(tree[flax_name], f"{prefix}.{name}", sd)


_ENCODER_BLOCKS: Tuple[str, ...] = (
    "encoder1_2", "encoder2_1", "encoder2_2", "encoder2_3", "encoder3_1",
    "encoder3_2", "encoder3_3", "encoder4_1", "encoder4_2", "encoder4_3",
    "encoder5_1", "encoder5_2", "encoder5_3",
)


def _layer(tree, prefix: str, sd) -> None:
    att = tree.get("RPEMultiHeadAttention_0") or tree["MultiHeadAttention_0"]
    for proj in ("proj_q", "proj_k", "proj_v"):
        _dense(att[proj], f"{prefix}.attention.{proj}", sd)
    if "proj_p_kernel" in att:
        sd[f"{prefix}.attention.proj_p_kernel"] = np.asarray(att["proj_p_kernel"])
        sd[f"{prefix}.attention.proj_p_bias"] = np.asarray(att["proj_p_bias"])
    _dense(tree["Dense_0"], f"{prefix}.linear", sd)
    _norm(tree["LayerNorm_0"], f"{prefix}.norm", sd)
    ao = tree["AttentionOutput_0"]
    _dense(ao["Dense_0"], f"{prefix}.output.expand", sd)
    _dense(ao["Dense_1"], f"{prefix}.output.squeeze", sd)
    _norm(ao["LayerNorm_0"], f"{prefix}.output.norm", sd)


def params_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map the JAX package's GaussRegModel parameter tree (the dict under
    "params") to the port model's state_dict."""
    sd: Dict[str, np.ndarray] = {}
    bb = tree["backbone"]
    _kpconv(bb["ConvBlock_0"]["KPConv_0"], "backbone.encoder1_1.conv", sd)
    _norm(bb["ConvBlock_0"]["MaskedGroupNorm_0"], "backbone.encoder1_1.norm", sd)
    for i, name in enumerate(_ENCODER_BLOCKS):
        _residual(bb[f"CheckpointResidualBlock_{i}"], f"backbone.{name}", sd)
    _unary(bb["UnaryBlock_0"], "backbone.decoder4", sd)
    _unary(bb["UnaryBlock_1"], "backbone.decoder3", sd)
    _dense(bb["Dense_0"], "backbone.decoder2", sd)

    tr = tree["transformer"]
    emb = tr["embedding"]
    _dense(emb["proj_d"], "transformer.embedding.proj_d", sd)
    _dense({"kernel": emb["proj_a_kernel"], "bias": emb["proj_a_bias"]},
           "transformer.embedding.proj_a", sd)
    _dense(tr["in_proj"], "transformer.in_proj", sd)
    _dense(tr["out_proj"], "transformer.out_proj", sd)
    layers = tr["transformer"]
    for name in layers:
        index = int(name.split("_")[1])  # layer_{i}_{self|cross}
        _layer(layers[name], f"transformer.transformer.layers.{index}", sd)

    sd["ot_alpha"] = np.asarray(tree["ot_alpha"], np.float32).reshape(())
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a JAX package checkpoint into the port model's state_dict. The
    file holds {"params": variables, optionally "opt_state": ...}, where
    variables is model.init's {"params": tree}; the optimizer state is
    dropped."""
    return params_from_flax(read_flax_msgpack(path)["params"]["params"])
