"""Tokenizer + chat-template layer (a copy of the JAX package's
`runtime/tokenizer.py`).

The HF `tokenizers` stack is loaded offline from a model directory, with
`transformers` imported only then; a byte-level tokenizer covers synthetic
runs with random weights (no files needed, vocab = 256 bytes + specials).
The port keeps its own copy so that it imports nothing from the JAX package.
"""

from __future__ import annotations

import os
from typing import List, Optional


class ByteTokenizer:
    """Trivial byte-level tokenizer for synthetic models (vocab 256 + specials)."""

    bos_id = 256
    eos_id = 257
    vocab_size = 258

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")

    @property
    def eos_ids(self):
        return {self.eos_id}

    def apply_chat_template(self, messages) -> str:
        out = []
        for m in messages:
            out.append(f"<|{m['role']}|>\n{m['content']}\n")
        out.append("<|assistant|>\n")
        return "".join(out)


class HFTokenizer:
    """Wrapper over transformers' tokenizer, loaded from a local directory."""

    def __init__(self, model_dir: str):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(model_dir, local_files_only=True)

    def encode(self, text: str) -> List[int]:
        return self.tok.encode(text, add_special_tokens=False)

    def decode(self, ids) -> str:
        return self.tok.decode(list(ids), skip_special_tokens=True)

    @property
    def eos_ids(self):
        ids = set()
        if self.tok.eos_token_id is not None:
            ids.add(self.tok.eos_token_id)
        # qwen uses <|im_end|> as the turn terminator
        for t in ("<|im_end|>", "<|eot_id|>"):
            tid = self.tok.convert_tokens_to_ids(t)
            if tid is not None and tid >= 0:
                ids.add(tid)
        return ids

    @property
    def vocab_size(self):
        return len(self.tok)

    def apply_chat_template(self, messages) -> str:
        return self.tok.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True
        )


def load_tokenizer(model_dir: Optional[str]):
    if model_dir and any(
        os.path.exists(os.path.join(model_dir, f))
        for f in ("tokenizer.json", "tokenizer.model", "tokenizer_config.json")
    ):
        return HFTokenizer(model_dir)
    return ByteTokenizer()
