"""CLIP byte-pair-encoding tokenizer (reads diffusers `tokenizer/` dirs).

A copy of `diffews_tpu/data/tokenizer.py` for the port, with the same rules.
Counterpart of the `CLIPTokenizer` the reference loads from the checkpoint
(`evaluation_util/main_oss.py:351-353`) and uses to embed the empty prompt
with `padding="do_not_pad"` (`marigold_pipeline_rgb_latent_noise.py:591-600`)
or padded to 77 (`temp_input_ids.pt`).  Implements the standard CLIP BPE:
lowercased, whitespace-normalized text, byte-level unicode mapping, merges
ranked by `merges.txt`, `</w>` end-of-word markers, bos/eos wrapping.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re
from typing import Dict, List, Optional


@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    model_max_length = 77

    def __init__(self, vocab: Dict[str, int], merges: List[str]):
        self.encoder = vocab
        self.decoder = {v: k for k, v in vocab.items()}
        self.byte_encoder = _bytes_to_unicode()
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.cache: Dict[str, str] = {}
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
            re.IGNORECASE,
        )
        self.bos_token_id = vocab.get("<|startoftext|>", 49406)
        self.eos_token_id = vocab.get("<|endoftext|>", 49407)
        self.pad_token_id = 0

    # -- construction -------------------------------------------------------

    @classmethod
    def from_pretrained(cls, path: str) -> "CLIPTokenizer":
        """Load from a diffusers `tokenizer/` dir (vocab.json + merges.txt)."""
        if os.path.isdir(os.path.join(path, "tokenizer")):
            path = os.path.join(path, "tokenizer")
        with open(os.path.join(path, "vocab.json")) as f:
            vocab = json.load(f)
        merges_path = os.path.join(path, "merges.txt")
        if os.path.exists(merges_path):
            with open(merges_path, encoding="utf-8") as f:
                merges = f.read().split("\n")
        else:
            with gzip.open(os.path.join(path, "bpe_simple_vocab_16e6.txt.gz"), "rt") as f:
                merges = f.read().split("\n")
        # first line is a version header; entries end at the special tokens
        merges = [m for m in merges[1:] if m and len(m.split()) == 2]
        return cls(vocab, merges)

    # -- BPE ----------------------------------------------------------------

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """Text -> BPE ids (no special tokens)."""
        ids: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def __call__(
        self,
        text: str,
        padding: str = "do_not_pad",
        max_length: Optional[int] = None,
        truncation: bool = True,
    ):
        """HF-compatible call: returns an object with `.input_ids` (1, L)."""
        import numpy as np

        max_length = max_length or self.model_max_length
        ids = [self.bos_token_id] + self.encode(text) + [self.eos_token_id]
        if truncation and len(ids) > max_length:
            ids = ids[: max_length - 1] + [self.eos_token_id]
        if padding == "max_length":
            ids = ids + [self.pad_token_id] * (max_length - len(ids))

        class _Out:
            input_ids = np.asarray([ids], dtype=np.int32)

        return _Out()

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        raw = bytearray(byte_decoder[c] for c in text if c in byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()
