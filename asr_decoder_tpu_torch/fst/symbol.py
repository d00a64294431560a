"""word-id ↔ word-string symbol table.

Capability parity with the reference ``WordSymbol``
(ref: src/my-decoder/wordid-to-wordstr.h:11-118): reads ``words.txt``
(``word id`` per line), bidirectional lookup, incremental add.
"""

from __future__ import annotations


class SymbolTable:
    def __init__(self):
        self._str2id: dict[str, int] = {}
        self._id2str: dict[int, str] = {}

    @staticmethod
    def read_text(path: str) -> "SymbolTable":
        t = SymbolTable()
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if len(parts) != 2:
                    raise ValueError(f"bad symbol line: {line!r}")
                t.add(parts[0], int(parts[1]))
        return t

    def write_text(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for i in sorted(self._id2str):
                f.write(f"{self._id2str[i]} {i}\n")

    def add(self, word: str, idx: int | None = None) -> int:
        if idx is None:
            idx = max(self._id2str, default=-1) + 1
        self._str2id[word] = idx
        self._id2str[idx] = word
        return idx

    def find_id(self, word: str) -> int:
        """Returns -1 if absent (reference behavior)."""
        return self._str2id.get(word, -1)

    def find_word(self, idx: int) -> str:
        return self._id2str.get(idx, "<unk>")

    def words(self, ids) -> list[str]:
        return [self.find_word(int(i)) for i in ids]

    def items(self):
        """(word, id) pairs."""
        return self._str2id.items()

    def __len__(self) -> int:
        return len(self._id2str)

    def __contains__(self, word: str) -> bool:
        return word in self._str2id
