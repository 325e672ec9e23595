"""A byte-level tokenizer of 256 ids, read from its ``tokenizer.json``
without the ``tokenizers`` or ``transformers`` packages.

The file this reads is a byte-level BPE with no merges: each byte of
the UTF-8 text is one token, and its id is the position of the byte's
character in the sorted ByteLevel alphabet (GPT-2's byte-to-unicode
map).  Hugging Face's ``AutoTokenizer`` loads the same file into a
``PreTrainedTokenizerFast`` that gives the same ids and text.  The tiny
trained checkpoint (``benchmarks/tiny_markov.py``) ships such a file,
written by :func:`write_tokenizer`.

:func:`is_byte_level` tells that form from any other tokenizer file;
``engine/llm.py::load_tokenizer`` reads a file of that form with
:class:`ByteLevelTokenizer` and leaves every other file to
``transformers``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, Optional, Union


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's ByteLevel map: each byte to a printable character."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


def byte_level_vocab() -> dict[str, int]:
    """The 256-entry vocab: the ByteLevel alphabet in sorted order."""
    return {ch: i for i, ch in enumerate(sorted(bytes_to_unicode().values()))}


def tokenizer_json() -> dict:
    """The ``tokenizer.json`` document of the byte-level tokenizer, key for
    key as ``tokenizers`` saves a ByteLevel BPE with no merges and
    ``add_prefix_space=False``."""
    byte_level = {"type": "ByteLevel", "add_prefix_space": False,
                  "trim_offsets": True, "use_regex": True}
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [], "normalizer": None,
        "pre_tokenizer": byte_level, "post_processor": None,
        "decoder": dict(byte_level, add_prefix_space=True),
        "model": {
            "type": "BPE", "dropout": None, "unk_token": None,
            "continuing_subword_prefix": None, "end_of_word_suffix": None,
            "fuse_unk": False, "byte_fallback": False,
            "ignore_merges": False, "vocab": byte_level_vocab(),
            "merges": [],
        },
    }


def write_tokenizer(save_dir: Union[str, Path]) -> None:
    """Write ``tokenizer.json`` and ``tokenizer_config.json`` into
    ``save_dir``, as the JAX harness's ``make_byte_tokenizer`` does."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    (save_dir / "tokenizer.json").write_text(
        json.dumps(tokenizer_json(), ensure_ascii=False, indent=2),
        encoding="utf-8")
    (save_dir / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast",
         "model_max_length": 4096}))


def is_byte_level(doc: dict) -> bool:
    """True when ``doc`` (a parsed ``tokenizer.json``) is the byte-level
    tokenizer of this module: BPE over exactly the sorted ByteLevel
    alphabet, no merges, no added tokens, no normalizer or post
    processor, ByteLevel pre-tokenizer (no prefix space) and decoder."""
    if not isinstance(doc, dict):
        return False
    model = doc.get("model") or {}
    pre = doc.get("pre_tokenizer") or {}
    dec = doc.get("decoder") or {}
    return (model.get("type") == "BPE"
            and model.get("vocab") == byte_level_vocab()
            and not model.get("merges")
            and not doc.get("added_tokens")
            and doc.get("normalizer") is None
            and doc.get("post_processor") is None
            and pre.get("type") == "ByteLevel"
            and pre.get("add_prefix_space") is False
            and dec.get("type") == "ByteLevel")


class ByteLevelTokenizer:
    """Encode and decode of the byte-level tokenizer, with the attributes
    the port's callers read (``eos_token_id`` is None, as Hugging Face's
    is for this file: the file names no special token)."""

    eos_token_id: Optional[int] = None
    chat_template: Optional[str] = None

    def __init__(self):
        vocab = byte_level_vocab()
        char_of = bytes_to_unicode()
        self._id_of_byte = [vocab[char_of[b]] for b in range(256)]
        self._byte_of_id = bytes(sorted(range(256),
                                        key=self._id_of_byte.__getitem__))

    @property
    def vocab_size(self) -> int:
        return 256

    def __len__(self) -> int:
        return 256

    def encode(self, text: str, add_special_tokens: bool = True
               ) -> list[int]:
        """One id per byte of ``text``'s UTF-8 encoding (the file has no
        special tokens, so ``add_special_tokens`` adds none)."""
        ids = self._id_of_byte
        return [ids[b] for b in text.encode("utf-8")]

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = False
               ) -> str:
        """The bytes of ``ids`` as UTF-8 text, each invalid sequence
        replaced by U+FFFD (as the ByteLevel decoder does)."""
        data = bytes(self._byte_of_id[int(i)] for i in ids)
        return data.decode("utf-8", errors="replace")
