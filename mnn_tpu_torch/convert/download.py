"""Model download / search / list.

Counterpart of the JAX package's `convert/download.py` (mnncli's model
list / download / search): thin wrappers over `huggingface_hub`, imported
inside the functions that need it, with the same alias table for the
configs the repo serves and the same local registry (`MNN_TPU_MODELS_DIR`,
else ~/.cache/mnn_tpu/models). The directories it fetches are what
`convert --hf` and `from_pretrained` read.

With no network (or no `huggingface_hub`, as on the card's machine),
`download` and `search` raise an actionable `RuntimeError` rather than
hang; `list_local` needs no network.
"""

from __future__ import annotations

import os
from typing import List, Optional

# curated aliases (mnncli's model market entries for the configs the repo serves)
ALIASES = {
    "qwen2-0.5b": "Qwen/Qwen2-0.5B-Instruct",
    "qwen2-7b": "Qwen/Qwen2-7B-Instruct",
    "qwen2.5-0.5b": "Qwen/Qwen2.5-0.5B-Instruct",
    "qwen3-0.6b": "Qwen/Qwen3-0.6B",
    "llama3.2-1b": "meta-llama/Llama-3.2-1B-Instruct",
    "llama3.2-3b": "meta-llama/Llama-3.2-3B-Instruct",
    "mistral-7b": "mistralai/Mistral-7B-Instruct-v0.3",
    "qwen1.5-moe-a2.7b": "Qwen/Qwen1.5-MoE-A2.7B-Chat",
    "qwen3-moe-30b-a3b": "Qwen/Qwen3-30B-A3B",
    "gemma2-2b": "google/gemma-2-2b-it",
    "gemma3-1b": "google/gemma-3-1b-it",
}

_WEIGHT_PATTERNS = ["*.safetensors", "*.json", "tokenizer.model",
                    "*.txt", "merges.txt"]


def models_dir() -> str:
    d = os.environ.get("MNN_TPU_MODELS_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "mnn_tpu", "models")
    os.makedirs(d, exist_ok=True)
    return d


def resolve(name: str) -> str:
    """Alias or repo id -> HF repo id."""
    return ALIASES.get(name.lower(), name)


def download(name: str, out: Optional[str] = None,
             revision: Optional[str] = None) -> str:
    """Fetch a model's weights and tokenizer (resumable). Returns the local
    directory."""
    repo = resolve(name)
    target = out or os.path.join(models_dir(), repo.replace("/", "--"))
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        raise RuntimeError(
            "model download needs the huggingface_hub package, which this environment "
            "lacks; place the checkpoint directory locally and pass its path instead") from e
    try:
        snapshot_download(
            repo_id=repo, local_dir=target, revision=revision,
            allow_patterns=_WEIGHT_PATTERNS,
        )
    except Exception as e:
        raise RuntimeError(
            f"download of {repo} failed ({type(e).__name__}: {e}); "
            "this environment may have no network egress — place the "
            "checkpoint directory locally and pass its path instead"
        ) from e
    return target


def search(query: str, limit: int = 20) -> List[dict]:
    """Search the hub (mnncli's search)."""
    try:
        from huggingface_hub import HfApi
    except ImportError as e:
        raise RuntimeError("hub search needs the huggingface_hub package, which this "
                           "environment lacks") from e

    try:
        hits = HfApi().list_models(search=query, limit=limit,
                                   sort="downloads", direction=-1)
        return [{"id": m.id, "downloads": m.downloads or 0,
                 "likes": m.likes or 0} for m in hits]
    except Exception as e:
        raise RuntimeError(
            f"hub search failed ({type(e).__name__}); no network egress?"
        ) from e


def list_local() -> List[str]:
    """Locally available downloads + converted checkpoints (no network)."""
    d = models_dir()
    out = []
    for entry in sorted(os.listdir(d)):
        p = os.path.join(d, entry)
        if os.path.isdir(p) and (
                os.path.exists(os.path.join(p, "config.json"))
                or os.path.exists(os.path.join(p, "model.safetensors"))):
            out.append(entry)
    return out
