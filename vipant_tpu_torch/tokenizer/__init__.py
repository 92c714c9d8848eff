"""Byte-level BPE tokenizer (CLIP vocabulary, 49,408 tokens).

Clean-room implementation of the standard byte-BPE algorithm over the public
OpenAI CLIP merges table (`bpe_simple_vocab_16e6.txt.gz`, shipped as a data
asset beside this file), including the ``as_list`` variable-length mode of
CLIP's tokenizer. The port's own copy of ``vipant_tpu/tokenizer/__init__.py``
(the port imports nothing of the JAX package).

Note on text cleaning: CLIP runs ``ftfy.fix_text`` before tokenizing. ftfy
is applied here when importable and skipped otherwise; for
the ASCII captions/prompts of AudioSet/Clotho/AudioCaps the two are
identical.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
from typing import Dict, List, Sequence, Tuple, Union

import regex as re

import numpy as np

__all__ = ["Tokenizer", "get_tokenizer", "tokenize", "SOT_TOKEN", "EOT_TOKEN"]

_VOCAB_PATH = os.path.join(os.path.dirname(__file__), "bpe_simple_vocab_16e6.txt.gz")

SOT_TEXT = "<|startoftext|>"
EOT_TEXT = "<|endoftext|>"


@functools.lru_cache()
def _byte_unicode_table() -> Dict[int, str]:
    """Invertible byte→printable-unicode map (the GPT-2 trick).

    Printable latin-1 bytes map to themselves; the rest are remapped above
    U+0100 so every byte has a visible, never-merged-away representation.
    """
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    table = {b: chr(b) for b in keep}
    shift = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + shift)
            shift += 1
    return table


def _basic_clean(text: str) -> str:
    try:  # optional: mojibake repair, identity for clean ASCII
        import ftfy  # type: ignore

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class Tokenizer:
    def __init__(self, bpe_path: str = _VOCAB_PATH):
        self.byte_encoder = _byte_unicode_table()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # line 0 is a header; the table is truncated to fill a 49,152-slot
        # vocab: 512 byte symbols + merges + 2 specials → 48,894 merges.
        merge_lines = lines[1 : 49152 - 256 - 2 + 1]
        merges: List[Tuple[str, str]] = [tuple(l.split()) for l in merge_lines]

        vocab: List[str] = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += [SOT_TEXT, EOT_TEXT]
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder: Dict[int, str] = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks: Dict[Tuple[str, str], int] = {m: i for i, m in enumerate(merges)}
        self.cache: Dict[str, str] = {SOT_TEXT: SOT_TEXT, EOT_TEXT: EOT_TEXT}
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
            r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
            re.IGNORECASE,
        )

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def sot_token(self) -> int:
        return self.encoder[SOT_TEXT]

    @property
    def eot_token(self) -> int:
        return self.encoder[EOT_TEXT]

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)

        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)

        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for chunk in re.findall(self.pat, text):
            chunk = "".join(self.byte_encoder[b] for b in chunk.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self._bpe(chunk).split(" "))
        return tokens

    def decode(self, tokens: Sequence[int]) -> str:
        text = "".join(self.decoder.get(int(t), "") for t in tokens)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


_TOKENIZER: Tokenizer = None  # lazy singleton; table load costs ~1 s


def get_tokenizer() -> Tokenizer:
    global _TOKENIZER
    if _TOKENIZER is None:
        _TOKENIZER = Tokenizer()
    return _TOKENIZER


def tokenize(
    texts: Union[str, Sequence[str]],
    context_length: int = 77,
    as_list: bool = False,
) -> Union[np.ndarray, List[List[int]]]:
    """Encode text(s) to ``<sot> tokens <eot>`` id sequences.

    With ``as_list=True`` returns ragged python lists (the reference data
    pipeline pads them per-batch); otherwise returns an int32 array of shape
    ``[n, context_length]``, zero-padded, raising if a text is too long.
    """
    if isinstance(texts, str):
        texts = [texts]
    tk = get_tokenizer()
    all_tokens = [[tk.sot_token] + tk.encode(t) + [tk.eot_token] for t in texts]
    if as_list:
        return all_tokens

    result = np.zeros((len(all_tokens), context_length), dtype=np.int32)
    for i, toks in enumerate(all_tokens):
        if len(toks) > context_length:
            raise RuntimeError(
                f"input {texts[i]!r} is too long for context length {context_length}"
            )
        result[i, : len(toks)] = toks
    return result


def detokenize_ids(row) -> str:
    """Decoded-caption string for one row of generated token ids: strips
    SOT/pad anywhere, truncates at the first EOT, BPE-decodes. The single
    detokenization used by both the trainer's caption report and the
    serving engine (divergent copies once produced different strings for
    the same ids)."""
    tk = get_tokenizer()
    toks = [int(t) for t in row if int(t) not in (0, tk.sot_token)]
    if tk.eot_token in toks:
        toks = toks[: toks.index(tk.eot_token)]
    return tk.decode(toks).strip()
