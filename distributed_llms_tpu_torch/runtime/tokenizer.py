"""Tokenization front-end.

The reference tokenizes on the master with a HF tokenizer and ships raw bytes
(src/master/node.py:235-245, defect D4 — the json.dumps of bytes always
throws) and never detokenizes (SURVEY §2.5).  Here: a uniform interface with
two backends — HF tokenizers when the files are available, and an offline
byte-level fallback so the framework is usable with zero network access.
Both sides round-trip: encode -> generate -> decode.
"""

from __future__ import annotations

import numpy as np


def _plain_chat_template(messages: list[dict]) -> str:
    """Model-agnostic fallback chat layout: ``role: content`` lines plus a
    trailing assistant cue.  Used when no model template is available."""
    lines = [f"{m['role']}: {m['content']}" for m in messages]
    return "\n".join(lines) + "\nassistant:"


class ByteTokenizer:
    """Byte-level tokenizer: ids 0..255 are raw bytes; specials follow.
    Deterministic, offline, round-trips any UTF-8 text."""

    PAD, BOS, EOS = 256, 257, 258
    vocab_size = 259

    @property
    def pad_id(self) -> int:
        return self.PAD

    @property
    def eos_id(self) -> int:
        return self.EOS

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = list(text.encode("utf-8"))
        return [self.BOS] + ids if add_bos else ids

    def decode(self, ids) -> str:
        data = bytes(i for i in ids if 0 <= int(i) < 256)
        return data.decode("utf-8", errors="replace")

    def token_bytes(self, i: int) -> bytes | None:
        """The exact byte content of one token id (constrained decoding
        builds token-mask automata from this — runtime/constrain.py).
        None for specials/out-of-range ids: they carry no text and are
        masked out of every grammar."""
        return bytes([i]) if 0 <= i < 256 else None

    def apply_chat_template(self, messages: list[dict]) -> str:
        """Plain-text fallback template (no model-specific control tokens
        exist at the byte level)."""
        return _plain_chat_template(messages)


class HFTokenizer:
    """Wrapper over a transformers tokenizer (requires local files)."""

    def __init__(self, name_or_path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(name_or_path)
        # len() includes added special tokens; .vocab_size does not.
        self.vocab_size = len(self._tok)

    @property
    def pad_id(self) -> int:
        pid = self._tok.pad_token_id
        return pid if pid is not None else (self._tok.eos_token_id or 0)

    @property
    def eos_id(self) -> int:
        return self._tok.eos_token_id if self._tok.eos_token_id is not None else -1

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        return self._tok.encode(text, add_special_tokens=add_bos)

    def decode(self, ids) -> str:
        return self._tok.decode([int(i) for i in ids], skip_special_tokens=True)

    def token_bytes(self, i: int) -> bytes | None:
        """Best-effort byte content of one token id for constrained
        decoding (runtime/constrain.py).  Specials, empty decodes, and
        tokens whose single-id decode is not faithful map to None
        (masked out of every grammar): a byte-level BPE vocabulary's
        UTF-8-FRAGMENT tokens decode to U+FFFD replacement characters,
        and building the automaton from those phantom bytes would
        enforce the grammar on content the model never emits —
        conservative masking keeps every allowed token's bytes exact
        (ASCII-coded grammars, i.e. all generated JSON structure, are
        unaffected; multi-byte text inside strings is reachable only
        through whole-character tokens)."""
        if not 0 <= i < self.vocab_size:
            return None
        if i in (self._tok.all_special_ids or ()):
            return None
        try:
            s = self._tok.decode([i])
        except Exception:
            return None
        if not s or "�" in s:
            return None
        return s.encode("utf-8")

    def apply_chat_template(self, messages: list[dict]) -> str:
        """The model's own chat template when it ships one (Llama/Mistral/
        Qwen/... control-token formats differ; the tokenizer files are the
        source of truth), else the plain-text fallback."""
        if getattr(self._tok, "chat_template", None):
            return self._tok.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True
            )
        return _plain_chat_template(messages)


def get_tokenizer(name_or_path: str | None):
    """HF tokenizer if files exist locally, else the byte fallback (with a
    loud warning — byte ids into a real model's vocab are gibberish)."""
    if name_or_path:
        try:
            return HFTokenizer(name_or_path)
        except Exception as e:
            import logging

            logging.getLogger("tokenizer").warning(
                "could not load HF tokenizer %r (%s); falling back to "
                "byte-level tokenizer", name_or_path, e,
            )
    return ByteTokenizer()


def pad_batch(
    sequences: list[list[int]], pad_id: int, length: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Right-pad to a common length.  Returns (tokens [B, T], lens [B])."""
    lens = np.array([len(s) for s in sequences], dtype=np.int32)
    t = int(length if length is not None else max(1, lens.max()))
    if lens.max() > t:
        raise ValueError(f"sequence length {lens.max()} exceeds pad length {t}")
    out = np.full((len(sequences), t), pad_id, dtype=np.int32)
    for i, s in enumerate(sequences):
        out[i, : len(s)] = s
    return out, lens
