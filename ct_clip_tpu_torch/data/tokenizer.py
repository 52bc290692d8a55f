"""Offline WordPiece tokenizer with HF BertTokenizer semantics.

Copy of ct_clip_tpu/data/tokenizer.py (framework-free).

The reference tokenizes reports with
`BertTokenizer.from_pretrained('microsoft/BiomedVLP-CXR-BERT-specialized',
do_lower_case=True)` padded to max_length 512 (scripts/CTCLIPTrainer.py:251,
zero_shot.py:134-136).  This implementation reproduces BertTokenizer's
BasicTokenizer (lowercase, accent strip, punctuation split, CJK spacing,
control-char cleanup) + greedy longest-match WordPiece, given a vocab.txt —
so it works air-gapped; when `transformers` can load the real repo it is
byte-compatible (verified in tests against BertTokenizer on a toy vocab).
"""
from __future__ import annotations

import unicodedata
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class WordPieceTokenizer:
    def __init__(self, vocab: Dict[str, int] | str | Path,
                 do_lower_case: bool = True, unk_token: str = "[UNK]",
                 cls_token: str = "[CLS]", sep_token: str = "[SEP]",
                 pad_token: str = "[PAD]", mask_token: str = "[MASK]",
                 max_input_chars_per_word: int = 100):
        if not isinstance(vocab, dict):
            vocab = self.load_vocab(vocab)
        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.do_lower_case = do_lower_case
        self.unk_token, self.cls_token = unk_token, cls_token
        self.sep_token, self.pad_token = sep_token, pad_token
        self.mask_token = mask_token
        self.max_input_chars_per_word = max_input_chars_per_word

    @staticmethod
    def load_vocab(path: str | Path) -> Dict[str, int]:
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return vocab

    # properties used by callers
    @property
    def pad_token_id(self) -> int:
        return self.vocab[self.pad_token]

    @property
    def mask_token_id(self) -> int:
        return self.vocab[self.mask_token]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def _clean_text(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _basic_tokenize(self, text: str) -> List[str]:
        text = self._clean_text(text)
        # CJK spacing
        spaced = []
        for ch in text:
            if _is_cjk(ord(ch)):
                spaced.extend((" ", ch, " "))
            else:
                spaced.append(ch)
        tokens = "".join(spaced).split()
        out = []
        for tok in tokens:
            if self.do_lower_case:
                tok = tok.lower()
                tok = unicodedata.normalize("NFD", tok)
                tok = "".join(c for c in tok if unicodedata.category(c) != "Mn")
            # split on punctuation
            cur: List[str] = []
            for ch in tok:
                if _is_punctuation(ch):
                    out.append("".join(cur)) if cur else None
                    out.append(ch)
                    cur = []
                else:
                    cur.append(ch)
            if cur:
                out.append("".join(cur))
        return [t for t in out if t]

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_token]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out = []
        for word in self._basic_tokenize(text):
            out.extend(self._wordpiece(word))
        return out

    def __call__(self, texts: str | Sequence[str], padding: str = "max_length",
                 truncation: bool = True, max_length: int = 512) -> Dict[str, np.ndarray]:
        """HF-call-compatible: returns {input_ids, attention_mask,
        token_type_ids} as int32 numpy arrays."""
        if isinstance(texts, str):
            texts = [texts]
        rows, masks = [], []
        for text in texts:
            toks = self.tokenize(text)
            if truncation:
                toks = toks[: max_length - 2]
            ids = ([self.vocab[self.cls_token]]
                   + [self.vocab.get(t, self.vocab[self.unk_token]) for t in toks]
                   + [self.vocab[self.sep_token]])
            mask = [1] * len(ids)
            if padding == "max_length":
                pad = max_length - len(ids)
                ids = ids + [self.pad_token_id] * pad
                mask = mask + [0] * pad
            rows.append(ids)
            masks.append(mask)
        if padding != "max_length":  # pad to longest
            longest = max(map(len, rows))
            rows = [r + [self.pad_token_id] * (longest - len(r)) for r in rows]
            masks = [m + [0] * (longest - len(m)) for m in masks]
        return {"input_ids": np.asarray(rows, np.int32),
                "attention_mask": np.asarray(masks, np.int32),
                "token_type_ids": np.zeros((len(rows), len(rows[0])), np.int32)}
