"""Quantized checkpoint directory: safetensors plus JSON sidecars.

Counterpart of `mnn_tpu/convert/checkpoint.py`, reading and writing the same
directory, so a checkpoint written by either package loads in the other:

* `model.safetensors`: every Params field under its dotted name
  ("embedding", "layers.wqkv.packed", "lm_head.scale", ...), with two
  metadata entries: `quant`, JSON {linear prefix: {bits, block_size,
  act_bits}}, and `casts`, JSON {name: "bfloat16"} for the bf16 tensors,
  which are stored as U16 bits as the JAX writer stores them. A file whose
  tensors are native BF16 loads too.
* `config.json`: the ModelConfig fields with `"mnn_tpu": true`;
* `runtime.json`: the RuntimeConfig;
* the tokenizer files of the source model, copied through.

Loading builds Params through `models/decoder.py` `params_from_numpy`, one
tensor at a time from a view of the mapped file straight onto the device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from collections.abc import Mapping
from typing import Optional, Tuple

import torch

from mnn_tpu_torch.convert.stfile import StFile, save_file
from mnn_tpu_torch.kernels.common import resolve_device
from mnn_tpu_torch.models.config import ModelConfig, RuntimeConfig
from mnn_tpu_torch.models.decoder import (Params, _check_supported,
                                          params_from_numpy)
from mnn_tpu_torch.quant.quantize import QuantizedLinear

_TOKENIZER_FILES = (
    "tokenizer.json", "tokenizer_config.json", "tokenizer.model",
    "special_tokens_map.json", "vocab.json", "merges.txt",
    "generation_config.json", "chat_template.jinja",
)
_QL_FIELDS = ("bits", "block_size", "act_bits")


def flatten(params: Params) -> Tuple[dict, dict]:
    """-> (tensors {name: tensor}, quant {linear prefix: its bits,
    block_size and act_bits}), under the checkpoint's names."""
    tensors, meta = {}, {}

    def put(prefix, val):
        if val is None:
            return
        if isinstance(val, QuantizedLinear):
            meta[prefix] = {f: getattr(val, f) for f in _QL_FIELDS}
            for f in ("packed", "scale", "bias", "out_bias"):
                put(f"{prefix}.{f}", getattr(val, f))
        else:
            tensors[prefix] = val

    put("embedding", params.embedding)
    put("final_norm", params.final_norm)
    put("lm_head", params.lm_head)
    for f in dataclasses.fields(params.layers):
        put(f"layers.{f.name}", getattr(params.layers, f.name))
    put("ple_table", params.ple_table)  # the JAX writer leaves it out
    return tensors, meta


def save_checkpoint(
    out_dir: str,
    config: ModelConfig,
    params: Params,
    rt: Optional[RuntimeConfig] = None,
    tokenizer_src: Optional[str] = None,
) -> None:
    """Write the checkpoint directory. The tensors may lie on the card:
    they reach the host one at a time."""
    os.makedirs(out_dir, exist_ok=True)
    tensors, meta = flatten(params)
    casts = {}
    for k, v in tensors.items():
        if v.dtype == torch.bfloat16:
            tensors[k] = v.view(torch.uint16)
            casts[k] = "bfloat16"
    save_file(tensors, os.path.join(out_dir, "model.safetensors"),
              metadata={"quant": json.dumps(meta), "casts": json.dumps(casts)})
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({"mnn_tpu": True, **dataclasses.asdict(config)}, f, indent=1)
    with open(os.path.join(out_dir, "runtime.json"), "w") as f:
        json.dump(dataclasses.asdict(rt or RuntimeConfig()), f, indent=1)
    if tokenizer_src:
        for name in _TOKENIZER_FILES:
            src = os.path.join(tokenizer_src, name)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(out_dir, name))


class _Entries(Mapping):
    """A checkpoint file as `params_from_numpy` reads it: each tensor as a
    view of the map (bf16 restored from its U16 bits), each quantized
    linear's bits, block_size and act_bits from the `quant` metadata."""

    def __init__(self, f: StFile):
        self.f = f
        md = f.metadata()
        self.casts = json.loads(md.get("casts", "{}"))
        self.ints = {}
        for prefix, m in json.loads(md.get("quant", "{}")).items():
            m = {"act_bits": 16, **m}
            for k in _QL_FIELDS:
                self.ints[f"{prefix}.{k}"] = int(m[k])
        self.names = set(f.names)

    def __getitem__(self, key):
        if key in self.ints:
            return self.ints[key]
        if key not in self.names:
            raise KeyError(key)
        t = self.f.tensor(key)
        if self.casts.get(key) == "bfloat16":
            t = t.view(torch.bfloat16)
        return t

    def __iter__(self):
        return iter(list(self.names) + list(self.ints))

    def __len__(self):
        return len(self.names) + len(self.ints)

    def __contains__(self, key):
        return key in self.ints or key in self.names


def load_checkpoint(model_dir: str, device=None):
    """-> (ModelConfig, Params on `device`, RuntimeConfig). `device=None`
    means the card. A config the port does not serve raises before any
    tensor is read."""
    device = resolve_device(device)
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg_d = json.load(f)
    cfg_d.pop("mnn_tpu", None)
    for k in ("rope_scaling", "mrope_section"):     # JSON lists -> hashable
        if isinstance(cfg_d.get(k), list):
            cfg_d[k] = tuple(cfg_d[k])
    config = ModelConfig(**cfg_d)
    _check_supported(config)
    rt_path = os.path.join(model_dir, "runtime.json")
    rt = RuntimeConfig.from_json(rt_path) if os.path.exists(rt_path) else RuntimeConfig()
    with StFile(os.path.join(model_dir, "model.safetensors")) as f:
        # every tensor is copied to `device` before the map closes
        params = params_from_numpy(_Entries(f), config, device)
    return config, params, rt
