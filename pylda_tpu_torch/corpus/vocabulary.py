"""Vocabulary handling.

One type per line in the vocab file; only the first whitespace field is
used; duplicates are dropped keeping the first occurrence; the resulting
order defines the type ids (the same rules as ``pylda_tpu``'s
``Vocabulary``, so both packages index a corpus identically).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence


class Vocabulary:
    """Bidirectional type <-> id mapping."""

    def __init__(self, types: Iterable[str]):
        self._index_to_type: List[str] = []
        self._type_to_index: Dict[str, int] = {}
        for t in types:
            if t and t not in self._type_to_index:
                self._type_to_index[t] = len(self._index_to_type)
                self._index_to_type.append(t)

    # -- construction -------------------------------------------------------

    @classmethod
    def from_file(cls, path: str) -> "Vocabulary":
        """Parse a voc.dat-style file: first whitespace field per line."""
        types = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                fields = line.strip().split()
                if fields:
                    types.append(fields[0])
        return cls(types)

    @classmethod
    def from_corpus_lines(cls, lines: Sequence[str]) -> "Vocabulary":
        """Build a vocabulary from raw document lines (sorted, so every
        process derives the same ids)."""
        seen = set()
        for line in lines:
            seen.update(line.lower().split())
        return cls(sorted(seen))

    # -- access --------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._index_to_type)

    def __contains__(self, t: str) -> bool:
        return t in self._type_to_index

    def __getitem__(self, index: int) -> str:
        return self._index_to_type[index]

    def id_of(self, t: str) -> int:
        return self._type_to_index[t]

    def get(self, t: str, default: int = -1) -> int:
        return self._type_to_index.get(t, default)

    @property
    def types(self) -> List[str]:
        return list(self._index_to_type)

    def to_file(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for t in self._index_to_type:
                f.write(t + "\n")
