"""Token vocabulary mapping words to model ids.

Contract (kept byte-compatible with the reference's saved vocabulary JSON so
checkpointed vocab files interoperate; cf. reference seq2seq/gSCAN_dataset.py:17-102):
``<PAD>`` is id 0 by construction, ``<SOS>`` id 1, ``<EOS>`` id 2; out-of-vocabulary
words map to the pad id.
"""

import json
import os
from collections import Counter
from typing import List


class Vocabulary:
    """Word <-> id mapping with reserved PAD=0 / SOS=1 / EOS=2 ids."""

    def __init__(self, sos_token: str = "<SOS>", eos_token: str = "<EOS>",
                 pad_token: str = "<PAD>"):
        self.sos_token = sos_token
        self.eos_token = eos_token
        self.pad_token = pad_token
        self._idx_to_word: List[str] = [pad_token, sos_token, eos_token]
        self._word_to_idx = {pad_token: 0, sos_token: 1, eos_token: 2}
        self._word_frequencies = Counter()

    def word_to_idx(self, word: str) -> int:
        # OOV words map to the pad id (reference behavior: defaultdict to pad).
        return self._word_to_idx.get(word, 0)

    def idx_to_word(self, idx: int) -> str:
        return self._idx_to_word[idx]

    def contains_word(self, word: str) -> bool:
        return self._word_to_idx.get(word, 0) != 0

    def add_sentence(self, sentence: List[str]):
        for word in sentence:
            if word not in self._word_to_idx:
                self._word_to_idx[word] = self.size
                self._idx_to_word.append(word)
            self._word_frequencies[word] += 1

    def most_common(self, n: int = 10):
        return self._word_frequencies.most_common(n=n)

    @property
    def pad_idx(self) -> int:
        return self._word_to_idx[self.pad_token]

    @property
    def sos_idx(self) -> int:
        return self._word_to_idx[self.sos_token]

    @property
    def eos_idx(self) -> int:
        return self._word_to_idx[self.eos_token]

    @property
    def size(self) -> int:
        return len(self._idx_to_word)

    def sentence_to_array(self, sentence: List[str]) -> List[int]:
        """Tokenize and wrap in SOS/EOS (cf. reference gSCAN_dataset.py:280-293)."""
        return [self.sos_idx] + [self.word_to_idx(w) for w in sentence] + [self.eos_idx]

    def array_to_sentence(self, ids: List[int]) -> List[str]:
        return [self.idx_to_word(int(i)) for i in ids]

    # -- persistence (JSON layout identical to reference gSCAN_dataset.py:73-102) --

    def to_dict(self) -> dict:
        return {
            "sos_token": self.sos_token,
            "eos_token": self.eos_token,
            "pad_token": self.pad_token,
            "idx_to_word": self._idx_to_word,
            "word_to_idx": dict(self._word_to_idx),
            "word_frequencies": dict(self._word_frequencies),
        }

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=4)
        return path

    @classmethod
    def load(cls, path: str) -> "Vocabulary":
        if not os.path.exists(path):
            raise FileNotFoundError(
                "Trying to load a vocabulary from a non-existing file {}".format(
                    path))
        with open(path) as f:
            data = json.load(f)
        vocab = cls(sos_token=data["sos_token"], eos_token=data["eos_token"],
                    pad_token=data["pad_token"])
        vocab._idx_to_word = list(data["idx_to_word"])
        vocab._word_to_idx = {w: int(i) for w, i in data["word_to_idx"].items()}
        vocab._word_frequencies = Counter(data["word_frequencies"])
        return vocab
