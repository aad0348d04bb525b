"""Mandarin phoneme lexicon utilities (follows deepxi_tpu/dsp/phoneme.py; a
JAX-free copy).

Parses the `entry | tokens` lexicon format (pinyin -> initial/final,
initial/final -> phoneme) into token dictionaries: index 0 is the '|'
separator token, consonant initials are un-toned, vowel finals expand with
tones 1-5, and '*' closes the dictionary. Lexicon files are user-supplied
data.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

_CONSONANTS = {"b", "p", "d", "t", "j", "q", "x", "m", "n", "f", "l", "g",
               "k", "h", "z", "c", "s", "r", "zh", "ch", "sh"}
_SKIP_ENTRIES = {"aa", "oo", "ee", "ii", "uu", "vv"}
_TONES = ("1", "2", "3", "4", "5")


class Dictionary:
    """Bidirectional token dictionary."""

    def __init__(self, entry2index: Dict[str, int], index2entry: Dict[int, str]):
        self.entry2Index = entry2index
        self.index2Entry = index2entry

    def __len__(self) -> int:
        return len(self.entry2Index)


def parse_lexicon(path: str) -> Tuple[Dict[str, str], Dictionary]:
    """Parse an `entry | tokens` lexicon.

    Returns (entry->tokens mapping, phoneme token Dictionary) with the
    tone-expansion rules above.
    """
    with open(path) as f:
        lines = [ln for ln in f if "|" in ln]

    mapping: Dict[str, str] = {}
    e2i: Dict[str, int] = {"|": 0}
    i2e: Dict[int, str] = {0: "|"}
    idx = 1

    def add(token: str):
        nonlocal idx
        if token not in e2i:
            e2i[token] = idx
            i2e[idx] = token
            idx += 1

    for line in lines:
        entry, _, tokens = line.partition("|")
        entry = entry.strip()
        if entry in _SKIP_ENTRIES:
            continue
        tokens = tokens.strip()
        mapping.setdefault(entry, tokens)
        phonemes = tokens.split()
        if len(phonemes) == 1 and phonemes[0] in _CONSONANTS:
            add(phonemes[0])
        else:
            for ph in phonemes:
                for tone in _TONES:
                    add(ph + tone)

    add("*")
    return mapping, Dictionary(e2i, i2e)


class Phoneme:
    """Phoneme tokenizer facade."""

    def __init__(self, lexicon_path: str):
        self.mapping, self.tkn_dict = parse_lexicon(lexicon_path)

    def tokens(self, entry: str, tone: str = "5") -> List[str]:
        """Phoneme tokens of a lexicon entry; vowels carry the given tone."""
        out = []
        for ph in self.mapping[entry].split():
            out.append(ph if ph in _CONSONANTS else ph + tone)
        return out

    def ids(self, labels: Sequence[str]) -> List[int]:
        """Token ids for per-frame phoneme labels."""
        return [self.tkn_dict.entry2Index[lbl.strip()] for lbl in labels]
