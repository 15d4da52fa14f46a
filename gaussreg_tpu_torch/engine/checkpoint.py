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

`flax_from_params` maps back (engine/torch_import.py fills that tree).

`save_checkpoint` writes the JAX package's checkpoint layout with a small
msgpack encoder of its own: `<name>.msgpack` holding {"params":
{"params": tree}, "opt_state": state} as `flax.serialization.to_bytes`
lays it out, plus a `<name>.json` sidecar, so that the JAX
`load_checkpoint` restores both; `load_checkpoint` reads either side's
files, optionally with the optimizer state (engine/trainer.py's state,
carried in the layout of `flax.serialization.to_state_dict` of the optax
state).
"""

from __future__ import annotations

import json
import logging
import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from gaussreg_tpu_torch.engine.summary import process_index

# flax/serialization.py _MsgpackExtType
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"
_MAX_CHUNK_BYTES = 2**30  # flax/serialization.py MAX_CHUNK_SIZE

logger = logging.getLogger("gaussreg")


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


def _pack(obj, out: bytearray) -> None:
    """msgpack encoding, as msgpack.packb(obj, use_bin_type=True) gives it,
    of what a checkpoint holds: dicts, str keys, non-negative ints (shapes),
    bytes, lists, and numpy arrays as flax's ndarray ext type."""
    if isinstance(obj, int) and 0 <= obj < 1 << 64:
        if obj <= 0x7F:
            out.append(obj)
        else:
            for code, n in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
                if obj < 1 << (8 * n):
                    out.append(code)
                    out += obj.to_bytes(n, "big")
                    break
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        if len(data) < 32:
            out.append(0xA0 | len(data))
        else:
            _length(out, len(data), (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, bytes):
        _length(out, len(obj), (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, list):
        if len(obj) < 16:
            out.append(0x90 | len(obj))
        else:
            _length(out, len(obj), (None, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        if len(obj) < 16:
            out.append(0x80 | len(obj))
        else:
            _length(out, len(obj), (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        if obj.nbytes > _MAX_CHUNK_BYTES:
            raise ValueError("arrays over 1 GiB are written in chunks by flax; not supported")
        payload = bytearray()
        _pack([list(obj.shape), obj.dtype.name, np.ascontiguousarray(obj).tobytes()], payload)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(payload) in fixed:
            out.append(fixed[len(payload)])
        else:
            _length(out, len(payload), (0xC7, 0xC8, 0xC9))
        out.append(_EXT_NDARRAY)
        out += payload
    else:
        raise TypeError(f"cannot encode {type(obj).__name__} in a checkpoint")


def _length(out: bytearray, n: int, codes) -> None:
    for code, width in zip(codes, (1, 2, 4)):
        if code is not None and n < 1 << (8 * width):
            out.append(code)
            out += n.to_bytes(width, "big")
            return
    raise ValueError(f"msgpack length {n} too large")


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


def _backbone(bb, prefix: str, sd) -> None:
    _kpconv(bb["ConvBlock_0"]["KPConv_0"], f"{prefix}.encoder1_1.conv", sd)
    _norm(bb["ConvBlock_0"]["MaskedGroupNorm_0"], f"{prefix}.encoder1_1.norm", sd)
    for i, name in enumerate(_ENCODER_BLOCKS):
        _residual(bb[f"CheckpointResidualBlock_{i}"], f"{prefix}.{name}", sd)
    _unary(bb["UnaryBlock_0"], f"{prefix}.decoder4", sd)
    _unary(bb["UnaryBlock_1"], f"{prefix}.decoder3", sd)
    _dense(bb["Dense_0"], f"{prefix}.decoder2", sd)


def _embedding(tree, prefix: str, sd) -> None:
    sd[f"{prefix}.embedding.weight"] = np.asarray(tree["Embed_0"]["embedding"])
    _norm(tree["LayerNorm_0"], f"{prefix}.norm", sd)


def _pe_attention(tree, prefix: str, sd) -> None:
    for proj in ("proj_q", "proj_p_q", "proj_k", "proj_p_k", "proj_v"):
        _dense(tree[proj], f"{prefix}.{proj}", sd)


def _lrpe_attention(tree, prefix: str, sd) -> None:
    for proj in ("proj_q", "proj_k", "proj_v"):
        _dense(tree[proj], f"{prefix}.{proj}", sd)
    _embedding(tree["LearnablePositionalEmbedding_0"], f"{prefix}.embedding", sd)


def _encoder(tree, prefix: str, sd) -> None:
    for name in tree:  # layer_{i}
        _layer(tree[name], f"{prefix}.layers.{int(name.split('_')[1])}", sd)


def _decoder(tree, prefix: str, sd) -> None:
    for name in tree:  # self_{i}, cross_{i}
        kind, index = name.split("_")
        _layer(tree[name], f"{prefix}.{kind}_layers.{int(index)}", sd)


def _conditional(tree, prefix: str, sd) -> None:
    for name in tree:  # layer_{i}_{self|cross}
        _layer(tree[name], f"{prefix}.layers.{int(name.split('_')[1])}", sd)


# the flax tree -> state_dict converter of each port module that a caller
# may carry across alone
_MODULE_CONVERTERS = {
    "KPConvFPN": _backbone,
    "LearnablePositionalEmbedding": _embedding,
    "PEMultiHeadAttention": _pe_attention,
    "LRPEMultiHeadAttention": _lrpe_attention,
    "TransformerEncoder": _encoder,
    "TransformerDecoder": _decoder,
    "VanillaConditionalTransformer": _conditional,
    "TransformerLayer": _layer,
    "RPETransformerLayer": _layer,
}


def module_params_from_flax(module: torch.nn.Module, tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The state_dict of one module of the port (the backbone, the six
    transformer variants and the two transformer layers) from the parameter
    tree of the JAX module of the same name (the dict under "params" of its
    init)."""
    name = type(module).__name__
    if name not in _MODULE_CONVERTERS:
        raise ValueError(f"no flax converter for {name}")
    sd: Dict[str, np.ndarray] = {}
    _MODULE_CONVERTERS[name](tree, "", sd)
    return {k[1:]: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}


def params_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map the JAX package's GaussRegModel parameter tree (the dict under
    "params") to the port model's state_dict."""
    sd: Dict[str, np.ndarray] = {}
    _backbone(tree["backbone"], "backbone", sd)

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


def flax_from_params(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of `params_from_flax`: the port model's state_dict as the
    JAX package's parameter tree (the dict under "params"), numpy leaves."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}

    def dense(prefix):
        return {"kernel": sd[f"{prefix}.weight"].T, "bias": sd[f"{prefix}.bias"]}

    def norm(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    def unary(prefix):
        return {"Dense_0": dense(f"{prefix}.linear"), "MaskedGroupNorm_0": norm(f"{prefix}.norm")}

    def kpconv(prefix):
        return {name: sd[f"{prefix}.{name}"] for name in ("weights", "kernel_points", "bias")}

    def residual(prefix):
        tree = {"KPConv_0": kpconv(f"{prefix}.conv"), "MaskedGroupNorm_0": norm(f"{prefix}.norm")}
        present = [n for n in ("unary1", "unary2", "unary_shortcut")
                   if f"{prefix}.{n}.linear.weight" in sd]  # flax's creation order
        for i, name in enumerate(present):
            tree[f"UnaryBlock_{i}"] = unary(f"{prefix}.{name}")
        return tree

    bb = {"ConvBlock_0": {"KPConv_0": kpconv("backbone.encoder1_1.conv"),
                          "MaskedGroupNorm_0": norm("backbone.encoder1_1.norm")},
          "UnaryBlock_0": unary("backbone.decoder4"), "UnaryBlock_1": unary("backbone.decoder3"),
          "Dense_0": dense("backbone.decoder2")}
    for i, name in enumerate(_ENCODER_BLOCKS):
        bb[f"CheckpointResidualBlock_{i}"] = residual(f"backbone.{name}")

    proj_a = dense("transformer.embedding.proj_a")
    tr = {"embedding": {"proj_d": dense("transformer.embedding.proj_d"),
                        "proj_a_kernel": proj_a["kernel"], "proj_a_bias": proj_a["bias"]},
          "in_proj": dense("transformer.in_proj"), "out_proj": dense("transformer.out_proj"),
          "transformer": {}}
    index = 0
    while f"transformer.transformer.layers.{index}.linear.weight" in sd:
        prefix = f"transformer.transformer.layers.{index}"
        rpe = f"{prefix}.attention.proj_p_kernel" in sd
        att = {p: dense(f"{prefix}.attention.{p}") for p in ("proj_q", "proj_k", "proj_v")}
        if rpe:
            att["proj_p_kernel"] = sd[f"{prefix}.attention.proj_p_kernel"]
            att["proj_p_bias"] = sd[f"{prefix}.attention.proj_p_bias"]
        tr["transformer"][f"layer_{index}_{'self' if rpe else 'cross'}"] = {
            "RPEMultiHeadAttention_0" if rpe else "MultiHeadAttention_0": att,
            "Dense_0": dense(f"{prefix}.linear"), "LayerNorm_0": norm(f"{prefix}.norm"),
            "AttentionOutput_0": {"Dense_0": dense(f"{prefix}.output.expand"),
                                  "Dense_1": dense(f"{prefix}.output.squeeze"),
                                  "LayerNorm_0": norm(f"{prefix}.output.norm")},
        }
        index += 1
    return {"backbone": bb, "transformer": tr, "ot_alpha": sd["ot_alpha"]}


# ------------------------------------------------------ optimizer state


def opt_state_to_flax(state) -> Any:
    """The port optimizer's state (engine/trainer.py) as
    `flax.serialization.to_state_dict` lays out the optax state: a
    NamedTuple becomes {field: ...}, a tuple {"0": ..., "1": ...}, a
    per-parameter dict the variables tree {"params": tree}, a count an
    int32 array."""
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return {f: opt_state_to_flax(getattr(state, f)) for f in state._fields}
    if isinstance(state, tuple):
        return {str(i): opt_state_to_flax(x) for i, x in enumerate(state)}
    if isinstance(state, dict):
        return {"params": flax_from_params(state)}
    return np.asarray(state, np.int32)


def opt_state_from_flax(template, tree) -> Any:
    """The inverse of `opt_state_to_flax`, shaped by a `template` state (the
    optimizer's `init`): tensors land on the template's devices."""
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        if set(tree) != set(template._fields):
            raise ValueError(f"optimizer state fields {sorted(tree)} are not "
                             f"{sorted(template._fields)}")
        return type(template)(**{f: opt_state_from_flax(getattr(template, f), tree[f])
                                 for f in template._fields})
    if isinstance(template, tuple):
        if len(tree) != len(template):
            raise ValueError(f"optimizer state holds {len(tree)} entries, expected "
                             f"{len(template)}")
        return tuple(opt_state_from_flax(t, tree[str(i)]) for i, t in enumerate(template))
    if isinstance(template, dict):
        loaded = params_from_flax(tree["params"])
        return {n: loaded[n].to(t.device, t.dtype) for n, t in template.items()}
    return int(np.asarray(tree))


def save_checkpoint(
    directory: str,
    name: str,
    params,
    opt_state: Any = None,
    metadata: Optional[Dict] = None,
) -> str:
    """Write `<directory>/<name>.msgpack` and its `.json` sidecar in the JAX
    package's layout. `params` is the model's state_dict (or its parameters
    by name, or the model); `opt_state` the optimizer state of
    engine/trainer.py. Only process 0 writes; every process returns the
    path."""
    path = os.path.join(directory, f"{name}.msgpack")
    if process_index() != 0:
        return path
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    payload = {"params": {"params": flax_from_params(params)}}
    if opt_state is not None:
        payload["opt_state"] = opt_state_to_flax(opt_state)
    data = bytearray()
    _pack(payload, data)
    os.makedirs(directory, exist_ok=True)
    with open(path + ".tmp", "wb") as f:
        f.write(bytes(data))
    os.replace(path + ".tmp", path)
    with open(os.path.join(directory, f"{name}.json"), "w") as f:
        json.dump(dict(metadata or {}), f)
    return path


def load_checkpoint(path: str, opt_state_template: Any = None):
    """Read a checkpoint of either package into the port model's
    state_dict. The file holds {"params": variables, optionally "opt_state":
    ...}, where variables is model.init's {"params": tree}. With an
    `opt_state_template` (the optimizer's `init`) returns (state_dict,
    opt_state); otherwise the optimizer state is dropped."""
    tree = read_flax_msgpack(path)
    params = params_from_flax(tree["params"]["params"])
    if opt_state_template is None:
        return params
    if "opt_state" not in tree:
        raise ValueError(f"{path} holds no optimizer state")
    return params, opt_state_from_flax(opt_state_template, tree["opt_state"])


def load_metadata(directory: str, name: str) -> Dict:
    """The `<name>.json` sidecar, or {} when there is none."""
    p = os.path.join(directory, f"{name}.json")
    if not os.path.exists(p):
        return {}
    with open(p) as f:
        return json.load(f)
