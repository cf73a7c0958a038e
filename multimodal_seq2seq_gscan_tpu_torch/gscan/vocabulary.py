"""Natural-language vocabulary: surface words bound to fixed semantic meanings.

Semantics live in fixed sets (walk; push/pull; six adverbs; three shapes; four
colors; big/small — cf. reference GroundedScan/vocabulary.py:10-15); surface words
may equal the meanings ('default'), be user-supplied, or be sampled nonce words.
"""

import random
import string
from typing import Dict, List, Set


_VOWELS = "aeiou"
_CONSONANTS = "".join(c for c in string.ascii_lowercase if c not in _VOWELS)


def _generate_nonce_word(rng: random.Random, min_syllables: int = 2,
                         max_syllables: int = 3) -> str:
    """Pronounceable CV-syllable nonce word (stand-in for the `pronounceable` dep)."""
    n = rng.randint(min_syllables, max_syllables)
    return "".join(rng.choice(_CONSONANTS) + rng.choice(_VOWELS)
                   for _ in range(n))


class Vocabulary:

    INTRANSITIVE_VERBS = {"walk"}
    TRANSITIVE_VERBS = {"push", "pull"}
    ADVERBS = {"quickly", "slowly", "while zigzagging", "while spinning",
               "cautiously", "hesitantly"}
    NOUNS = {"circle", "square", "cylinder"}
    COLOR_ADJECTIVES = {"green", "red", "blue", "yellow"}
    SIZE_ADJECTIVES = {"small", "big"}

    def __init__(self, intransitive_verbs: Dict[str, str],
                 transitive_verbs: Dict[str, str], adverbs: Dict[str, str],
                 nouns: Dict[str, str], color_adjectives: Dict[str, str],
                 size_adjectives: Dict[str, str]):
        all_words = (list(intransitive_verbs) + list(transitive_verbs)
                     + list(adverbs) + list(nouns) + list(color_adjectives)
                     + list(size_adjectives))
        assert len(all_words) == len(set(all_words)), (
            "Overlapping vocabulary (the same string used twice).")
        self._intransitive_verbs = intransitive_verbs
        self._transitive_verbs = transitive_verbs
        self._adverbs = adverbs
        self._nouns = nouns
        self._color_adjectives = color_adjectives
        self._size_adjectives = size_adjectives
        if len(color_adjectives) > 0 and len(size_adjectives) > 0:
            self._adjectives = (list(color_adjectives.values())
                                + list(size_adjectives.values()))
        elif len(color_adjectives) > 0:
            self._adjectives = list(color_adjectives.values())
        else:
            self._adjectives = list(size_adjectives.values())
        self._translation_table = {"to": "to", "a": "a", "and": "and"}
        for table in (intransitive_verbs, transitive_verbs, nouns,
                      color_adjectives, size_adjectives, adverbs):
            self._translation_table.update(table)
        self._translate_to = {meaning: word
                              for word, meaning in self._translation_table.items()}

    def get_intransitive_verbs(self) -> List[str]:
        return list(self._intransitive_verbs.keys())

    def get_transitive_verbs(self) -> List[str]:
        return list(self._transitive_verbs.keys())

    def get_adverbs(self) -> List[str]:
        return list(self._adverbs.keys())

    def get_nouns(self) -> List[str]:
        return list(self._nouns.keys())

    def get_color_adjectives(self) -> List[str]:
        return list(self._color_adjectives.keys())

    def get_size_adjectives(self) -> List[str]:
        return list(self._size_adjectives.keys())

    def get_semantic_shapes(self) -> List[str]:
        return list(self._nouns.values())

    def get_semantic_colors(self) -> List[str]:
        return list(self._color_adjectives.values())

    def translate_word(self, word: str) -> str:
        """Surface word -> semantic meaning ('' if unknown)."""
        return self._translation_table.get(word, "")

    def translate_meaning(self, meaning: str) -> str:
        """Semantic meaning -> surface word ('' if unknown)."""
        return self._translate_to.get(meaning, "")

    @property
    def n_attributes(self) -> int:
        return len(self._nouns) * len(self._color_adjectives)

    @staticmethod
    def bind_words_to_meanings(available_words: List[str],
                               available_meanings: Set[str]) -> Dict[str, str]:
        assert len(available_words) <= len(available_meanings), (
            "Too many words specified for available semantic meanings: {}".format(
                available_meanings))
        translation_table = {}
        for word in available_words:
            if word in available_meanings:
                translation_table[word] = word
                available_meanings.remove(word)
            else:
                translation_table[word] = available_meanings.pop()
        return translation_table

    @classmethod
    def initialize(cls, intransitive_verbs: List[str], transitive_verbs: List[str],
                   adverbs: List[str], nouns: List[str],
                   color_adjectives: List[str], size_adjectives: List[str]):
        return cls(
            cls.bind_words_to_meanings(intransitive_verbs,
                                       cls.INTRANSITIVE_VERBS.copy()),
            cls.bind_words_to_meanings(transitive_verbs, cls.TRANSITIVE_VERBS.copy()),
            cls.bind_words_to_meanings(adverbs, cls.ADVERBS.copy()),
            cls.bind_words_to_meanings(nouns, cls.NOUNS.copy()),
            cls.bind_words_to_meanings(color_adjectives,
                                       cls.COLOR_ADJECTIVES.copy()),
            cls.bind_words_to_meanings(size_adjectives, cls.SIZE_ADJECTIVES.copy()))

    @classmethod
    def sample(cls, num_intransitive=1, num_transitive=1, num_adverbs=6, num_nouns=3,
               num_color_adjectives=3, num_size_adjectives=2,
               rng: random.Random = None):
        """Initialize with nonce words drawn from ``rng`` (a fresh unseeded
        generator if None) bound to the fixed meanings."""
        rng = rng if rng is not None else random.Random()

        def nonce(n):
            return [_generate_nonce_word(rng) for _ in range(n)]
        return cls(
            cls.bind_words_to_meanings(nonce(num_intransitive),
                                       cls.INTRANSITIVE_VERBS.copy()),
            cls.bind_words_to_meanings(nonce(num_transitive),
                                       cls.TRANSITIVE_VERBS.copy()),
            cls.bind_words_to_meanings(nonce(num_adverbs), cls.ADVERBS.copy()),
            cls.bind_words_to_meanings(nonce(num_nouns), cls.NOUNS.copy()),
            cls.bind_words_to_meanings(nonce(num_color_adjectives),
                                       cls.COLOR_ADJECTIVES.copy()),
            cls.bind_words_to_meanings(nonce(num_size_adjectives),
                                       cls.SIZE_ADJECTIVES.copy()))

    def to_representation(self) -> dict:
        return {
            "intransitive_verbs": self._intransitive_verbs,
            "transitive_verbs": self._transitive_verbs,
            "nouns": self._nouns,
            "adverbs": self._adverbs,
            "color_adjectives": self._color_adjectives,
            "size_adjectives": self._size_adjectives,
        }

    @classmethod
    def from_representation(cls, rep: Dict[str, Dict[str, str]]):
        return cls(rep["intransitive_verbs"], rep["transitive_verbs"],
                   rep["adverbs"], rep["nouns"], rep["color_adjectives"],
                   rep["size_adjectives"])
