"""Phone/pinyin-sequence → word alignment.

Capability parity with the reference align module — a phone trie over the
lexicon (ref: src/align/phone-to-word.h:20-118 ``PinyinNode``/``PinyinTree``)
and greedy longest-match segmentation of a decoded phone sequence into words
with per-word phone spans (ref: ``PhoneToWord`` phone-to-word.h:122,
``AlignInfo`` src/align/align-info.h).

Host-side by design: alignment is a post-search, per-result string operation
off the device hot path (SURVEY §7 keeps such irregular post-passes native/
host-side).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TrieNode:
    """ref: PinyinNode (phone-to-word.h:20)."""
    children: dict[int, "TrieNode"] = field(default_factory=dict)
    word_ids: list[int] = field(default_factory=list)   # words ending here


@dataclass
class AlignSpan:
    """One aligned word (ref: AlignInfo, align/align-info.h)."""
    word_id: int
    phone_start: int   # index into the phone sequence
    phone_end: int     # exclusive


class PhoneToWord:
    """Lexicon trie + phone-sequence segmentation (ref: phone-to-word.h:122).

    ``add_entry(word_id, phones)`` builds the trie; ``align`` segments a
    phone-id sequence into lexicon words by greedy longest match with
    single-phone backoff, returning (word_ids, spans, ok).
    """

    def __init__(self):
        self._root = TrieNode()

    @staticmethod
    def read_lexicon(path: str, words, phones) -> "PhoneToWord":
        """Text lexicon ``word p1 p2 ...`` per line; ``words``/``phones``
        are SymbolTables (ref: PhoneToWord::Init reads word+phone dicts)."""
        p2w = PhoneToWord()
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                wid = words.find_id(parts[0])
                pids = [phones.find_id(p) for p in parts[1:]]
                if wid < 0 or any(p < 0 for p in pids):
                    continue
                p2w.add_entry(wid, pids)
        return p2w

    def add_entry(self, word_id: int, phones: list[int]) -> None:
        node = self._root
        for p in phones:
            node = node.children.setdefault(int(p), TrieNode())
        node.word_ids.append(int(word_id))

    def longest_match(self, phones: list[int], start: int) \
            -> tuple[int, int] | None:
        """Longest lexicon entry starting at ``start``; returns
        (word_id, match_len) or None."""
        node = self._root
        best: tuple[int, int] | None = None
        i = start
        while i < len(phones):
            node = node.children.get(int(phones[i]))
            if node is None:
                break
            i += 1
            if node.word_ids:
                best = (node.word_ids[0], i - start)
        return best

    def align(self, phones: list[int]) \
            -> tuple[list[int], list[AlignSpan], bool]:
        """Greedy longest-match segmentation; unmatched phones are skipped
        and flagged (ok=False), mirroring the reference's failure reporting."""
        words: list[int] = []
        spans: list[AlignSpan] = []
        ok = True
        i = 0
        while i < len(phones):
            m = self.longest_match(phones, i)
            if m is None:
                ok = False
                i += 1
                continue
            wid, n = m
            words.append(wid)
            spans.append(AlignSpan(wid, i, i + n))
            i += n
        return words, spans, ok

    def align_with_frames(self, phones: list[int], frame_ends: list[int]) \
            -> tuple[list[int], list[tuple[int, int]], bool]:
        """Word time alignment: ``frame_ends[i]`` is the last frame of
        phone i; returns per-word (start_frame, end_frame)."""
        words, spans, ok = self.align(phones)
        times = []
        for s in spans:
            start_f = 0 if s.phone_start == 0 else \
                frame_ends[s.phone_start - 1] + 1
            times.append((start_f, frame_ends[s.phone_end - 1]))
        return words, times, ok
