"""The coarse model's weights as the reference reads them: the checkpoint's
parameter tree (a flax msgpack file, decoded here by a small msgpack reader
of the benchmark's own), or a tree of the same names and shapes drawn from a
seed for the tests' small configurations. A tree is nested dicts of numpy
float32 arrays; `tensors` moves it to a device."""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np


class _Msgpack:
    """Decodes the msgpack subset a flax checkpoint uses: maps, arrays,
    strings, bytes, integers, floats, nil, booleans, and flax's ndarray
    extension (code 1: a msgpack array of shape, dtype name, raw bytes)."""

    def __init__(self, buf: bytes):
        self.buf, self.pos = memoryview(buf), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends early")
        self.pos += n
        return self.buf[self.pos - n:self.pos]

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def value(self) -> Any:
        b = self.uint(1)
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return {self.value(): self.value() for _ in range(b & 0x0F)}
        if b < 0xA0:
            return [self.value() for _ in range(b & 0x0F)]
        if b < 0xC0:
            return bytes(self.take(b & 0x1F)).decode()
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.uint(1 << (b - 0xC4))))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.uint(1 << (b - 0xC7))
            return self.ext(self.uint(1), n)
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if b <= 0xCF:
            return self.uint(1 << (b - 0xCC))
        if b <= 0xD3:
            return int.from_bytes(self.take(1 << (b - 0xD0)), "big", signed=True)
        if b <= 0xD8:
            code = self.uint(1)
            return self.ext(code, 1 << (b - 0xD4))
        if b <= 0xDB:
            return bytes(self.take(self.uint(1 << (b - 0xD9)))).decode()
        if b <= 0xDD:
            return [self.value() for _ in range(self.uint(2 if b == 0xDC else 4))]
        if b <= 0xDF:
            n = self.uint(2 if b == 0xDE else 4)
            return {self.value(): self.value() for _ in range(n)}
        raise ValueError(f"msgpack type byte 0x{b:02x} is not read here")

    def ext(self, code: int, n: int) -> Any:
        data = bytes(self.take(n))
        if code != 1:
            raise ValueError(f"msgpack extension {code} is not read here")
        shape, dtype, raw = _Msgpack(data).value()
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


def read(path: str) -> Dict:
    """The parameter tree of a flax checkpoint file ({"params": {"params":
    tree}, ...})."""
    with open(path, "rb") as f:
        doc = _Msgpack(f.read()).value()
    return doc["params"]["params"]


def _residual_blocks(d: int):
    """(in, out) channels of the backbone's residual blocks in order."""
    return [(d, 2 * d), (2 * d, 2 * d), (2 * d, 4 * d), (4 * d, 4 * d), (4 * d, 4 * d),
            (4 * d, 8 * d), (8 * d, 8 * d), (8 * d, 8 * d), (8 * d, 16 * d), (16 * d, 16 * d),
            (16 * d, 16 * d), (16 * d, 32 * d), (32 * d, 32 * d)]


def shapes(config: dict) -> Dict:
    """The tree's names and shapes for a configuration file's widths."""
    bb, gt = config["backbone"], config["geotransformer"]
    d, k, c_in, g = bb["init_dim"], bb["kernel_size"], bb["input_dim"], gt["hidden_dim"]

    def dense(i, o):
        return {"kernel": (i, o), "bias": (o,)}

    def norm(c):
        return {"scale": (c,), "bias": (c,)}

    def unary(i, o):
        return {"Dense_0": dense(i, o), "MaskedGroupNorm_0": norm(o)}

    def kpconv(i, o):
        return {"weights": (k, i, o), "bias": (o,), "kernel_points": (k, 3)}

    backbone = {"ConvBlock_0": {"KPConv_0": kpconv(c_in, d), "MaskedGroupNorm_0": norm(d)}}
    for j, (i, o) in enumerate(_residual_blocks(d)):
        mid, subs = o // 4, []
        if i != mid:
            subs.append(unary(i, mid))
        subs.append(unary(mid, o))
        if i != o:
            subs.append(unary(i, o))
        block = {"KPConv_0": kpconv(mid, mid), "MaskedGroupNorm_0": norm(mid)}
        block.update({f"UnaryBlock_{n}": s for n, s in enumerate(subs)})
        backbone[f"CheckpointResidualBlock_{j}"] = block
    backbone["UnaryBlock_0"] = unary(48 * d, 16 * d)
    backbone["UnaryBlock_1"] = unary(24 * d, 8 * d)
    backbone["Dense_0"] = dense(12 * d, bb["output_dim"])

    layers = {}
    for j, kind in enumerate(gt["blocks"]):
        att = {p: dense(g, g) for p in ("proj_q", "proj_k", "proj_v")}
        if kind == "self":
            att.update(proj_p_kernel=(g, g), proj_p_bias=(g,))
        layers[f"layer_{j}_{kind}"] = {
            ("RPEMultiHeadAttention_0" if kind == "self" else "MultiHeadAttention_0"): att,
            "Dense_0": dense(g, g),
            "LayerNorm_0": norm(g),
            "AttentionOutput_0": {"Dense_0": dense(g, 2 * g), "Dense_1": dense(2 * g, g),
                                  "LayerNorm_0": norm(g)},
        }
    transformer = {
        "embedding": {"proj_d": dense(g, g), "proj_a_kernel": (g, g), "proj_a_bias": (g,)},
        "in_proj": dense(32 * d, g),
        "transformer": layers,
        "out_proj": dense(g, gt["output_dim"]),
    }
    return {"backbone": backbone, "transformer": transformer, "ot_alpha": ()}


def seeded(config: dict, seed: int) -> Dict:
    """A tree of the configuration's shapes drawn from `seed`: every kernel
    normal with variance 1 / fan-in, norms' scales 1, biases 0.1 normal,
    ot_alpha 1."""
    rng = np.random.default_rng(seed)

    def draw(name, shape):
        if isinstance(shape, dict):
            return {k: draw(k, v) for k, v in shape.items()}
        if name == "ot_alpha":
            return np.ones((), np.float32)
        if name == "scale":
            return np.ones(shape, np.float32)
        if name == "kernel_points":
            return np.zeros(shape, np.float32)
        if name.endswith("bias"):
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1]))
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    return {k: draw(k, v) for k, v in shapes(config).items()}


def tensors(tree: Dict, device) -> Dict:
    """The tree with every array a float32 tensor on `device`."""
    import torch

    if isinstance(tree, dict):
        return {k: tensors(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree, np.float32), device=device)
