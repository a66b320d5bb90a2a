"""WordPiece ``BertTokenizer`` of the port's own, from a local ``vocab.txt``.

The counterpart of what the root ``prepro.py`` (:215-233) takes from
``transformers.BertTokenizer``: the same tokens and ids for the same
vocabulary and ``do_lower_case``, with no ``transformers`` import (the
machine with the card has none).

``tokenize`` runs, in order:

1. The special tokens ``[UNK] [SEP] [PAD] [CLS] [MASK]`` are cut out of the
   text wherever they stand and never split. With ``do_lower_case`` every
   other character is lowered one at a time first (``transformers``'
   ``PreTrainedTokenizer.tokenize``).
2. BasicTokenizer on each remaining piece: drop NUL, U+FFFD and control
   characters (category ``C*`` but tab, newline, return), map whitespace
   (those three, space, category ``Zs``) to a space, put a space around
   each CJK ideograph, NFC-normalize, split on whitespace; with
   ``do_lower_case`` lower each word and strip its accents (NFD, drop
   category ``Mn``); split on punctuation (ASCII 33-47, 58-64, 91-96,
   123-126 and category ``P*``).
3. WordPiece on each word: greedy longest-match-first with the ``##``
   continuation; a word longer than 100 characters, or one with no full
   match, becomes a single ``[UNK]``.

``build_tokenizer`` takes a ``vocab.txt`` path or a directory holding one
and refuses a hub name (``bert-base-cased``): the root ``prepro.py`` would
download that vocabulary, and these machines have no network.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, List

SPECIAL_TOKENS = ("[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]")
MAX_CHARS_PER_WORD = 100

# the CJK Unified Ideographs blocks and their extensions and compatibility
# forms (transformers' BasicTokenizer._is_chinese_char)
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
        (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF),
        (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def load_vocab(path: str) -> Dict[str, int]:
    """token -> id, one token a line (the line's number is its id)."""
    with open(path, encoding="utf-8") as f:
        return {line.rstrip("\n"): i for i, line in enumerate(f)}


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in _CJK)


def _split_specials(text: str) -> List[str]:
    """``text`` cut at every special token, leftmost first; the tokens
    stay as pieces of their own."""
    out, start, i = [], 0, 0
    while i < len(text):
        hit = next((s for s in SPECIAL_TOKENS if text.startswith(s, i)),
                   None)
        if hit is None:
            i += 1
            continue
        out += [text[start:i], hit]
        i = start = i + len(hit)
    out.append(text[start:])
    return [p for p in out if p]


class BertTokenizer:
    """BasicTokenizer + WordPiece over ``vocab`` (module docstring)."""

    def __init__(self, vocab_file: str, do_lower_case: bool = False):
        self.vocab = load_vocab(vocab_file)
        self.do_lower_case = do_lower_case
        self.unk_id = self.vocab.get("[UNK]")

    def _basic(self, text: str) -> List[str]:
        chars = []
        for ch in text:
            if ch in ("\0", "\ufffd") or _is_control(ch):
                continue
            if _is_whitespace(ch):
                chars.append(" ")
            elif _is_cjk(ch):
                chars += [" ", ch, " "]
            else:
                chars.append(ch)
        words = []
        for word in unicodedata.normalize("NFC", "".join(chars)).split():
            if self.do_lower_case:
                word = "".join(
                    c for c in unicodedata.normalize("NFD", word.lower())
                    if unicodedata.category(c) != "Mn")
            piece = []
            for ch in word:
                if _is_punctuation(ch):
                    if piece:
                        words.append("".join(piece))
                        piece = []
                    words.append(ch)
                else:
                    piece.append(ch)
            if piece:
                words.append("".join(piece))
        # stripping an accent can leave a word of whitespace alone
        return " ".join(words).split()

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > MAX_CHARS_PER_WORD:
            return ["[UNK]"]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.vocab:
                    break
                end -= 1
            else:
                return ["[UNK]"]
            pieces.append(sub)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        tokens = []
        for piece in _split_specials(text):
            if piece in SPECIAL_TOKENS:
                tokens.append(piece)
                continue
            if self.do_lower_case:
                piece = "".join(c.lower() for c in piece)
            for word in self._basic(piece):
                tokens += self._wordpiece(word)
        return tokens

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        return [self.vocab.get(t, self.unk_id) for t in tokens]


def build_tokenizer(toker: str) -> BertTokenizer:
    """The tokenizer of a local vocabulary: ``toker`` is a ``vocab.txt``
    (cased, as the root ``prepro.py`` reads a file) or a directory holding
    one (lower-cased when its name says ``uncased``, as
    ``BertTokenizer.from_pretrained`` is called there). A hub name such as
    ``bert-base-cased`` raises ``ValueError``: the root ``prepro.py``
    (:220-222) downloads it, and the port reads only local files."""
    if os.path.isfile(toker):
        return BertTokenizer(toker, do_lower_case=False)
    vocab = os.path.join(toker, "vocab.txt")
    if os.path.isdir(toker) and os.path.isfile(vocab):
        name = os.path.basename(os.path.normpath(toker))
        return BertTokenizer(vocab, do_lower_case="uncased" in name)
    raise ValueError(
        f"--toker {toker!r} is neither a vocab.txt nor a directory holding "
        "one: the port needs a local vocabulary and downloads nothing")
