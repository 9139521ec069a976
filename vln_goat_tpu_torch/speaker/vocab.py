"""Legacy whitespace speaker vocabulary + tokenizer: the port's own copy
of vln_goat_tpu/speaker/vocab.py (pure Python).

Reference: the R2R-EnvDrop Tokenizer (map_nav_src/utils/data.py:290-400)
and build_vocab in speaker_utils — the speaker decodes over this small
whitespace vocab, not the RoBERTa subwords.  Conventions preserved:
special tokens <PAD>(0) <UNK> <EOS>; <BOS> appended after vocab build;
sentences split on non-alphanumerics with punctuation broken apart;
`shrink` cuts at the first <EOS> and strips <BOS>/<PAD>.
"""
from __future__ import annotations

import re
import string
from collections import Counter
from typing import Dict, Iterable, List

SENTENCE_SPLIT_REGEX = re.compile(r"(\W+)")
BASE_VOCAB = ["<PAD>", "<UNK>", "<EOS>"]


def split_sentence(sentence: str) -> List[str]:
    toks: List[str] = []
    for word in [s.strip().lower()
                 for s in SENTENCE_SPLIT_REGEX.split(sentence.strip())
                 if len(s.strip()) > 0]:
        if all(c in string.punctuation for c in word) and \
                not all(c in "." for c in word):
            toks += list(word)
        else:
            toks.append(word)
    return toks


def build_vocab(sentences: Iterable[str], min_count: int = 5) -> List[str]:
    count = Counter()
    for s in sentences:
        count.update(split_sentence(s))
    vocab = list(BASE_VOCAB)
    for word, n in count.most_common():
        if n >= min_count:
            vocab.append(word)
    return vocab


class SpeakerTokenizer:
    def __init__(self, vocab: List[str], encoding_length: int = 120):
        self.encoding_length = encoding_length
        self.vocab = list(vocab)
        self.word_to_index: Dict[str, int] = {w: i for i, w in
                                              enumerate(self.vocab)}
        self.index_to_word = {i: w for w, i in self.word_to_index.items()}
        # <BOS> appended last (utils/data.py:307-309)
        self.word_to_index["<BOS>"] = len(self.vocab)
        self.index_to_word[len(self.vocab)] = "<BOS>"
        self.vocab.append("<BOS>")

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def pad_id(self):
        return self.word_to_index["<PAD>"]

    @property
    def bos_id(self):
        return self.word_to_index["<BOS>"]

    @property
    def eos_id(self):
        return self.word_to_index["<EOS>"]

    @property
    def unk_id(self):
        return self.word_to_index["<UNK>"]

    def encode_sentence(self, sentence: str,
                        max_length: int = None) -> List[int]:
        L = max_length or self.encoding_length
        ids = [self.bos_id]
        for w in split_sentence(sentence):
            ids.append(self.word_to_index.get(w, self.unk_id))
        ids.append(self.eos_id)
        ids = ids[:L]
        ids += [self.pad_id] * (L - len(ids))
        return ids

    def shrink(self, ids: List[int]) -> List[int]:
        """Cut at <EOS>, strip <BOS>/<PAD> (utils/data.py shrink)."""
        out = []
        for t in ids:
            t = int(t)
            if t == self.eos_id:
                break
            if t in (self.bos_id, self.pad_id):
                continue
            out.append(t)
        return out

    def decode_sentence(self, ids: List[int]) -> str:
        return " ".join(self.index_to_word.get(int(t), "<UNK>")
                        for t in self.shrink(list(ids)))
