"""Chapter mining: YouTube descriptions -> (title, time) chapter lists.

Counterpart of ``vidchapters_tpu/factory/chapters.py``, a copy. Behavioral
port of collection/chapter_utils.py:1-67 + desc2chapters.py:25-38:
timestamp lines are detected (``\\d:\\d\\d``), URLs stripped, timestamps parsed
from h:mm:ss / mm:ss variants (rejecting malformed 3-digit / 4-group forms),
titles cleaned to the alnum-bounded core; a description yields chapters only
when >1 clean chapter remains, titles are not all single chars, and times
strictly increase.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

_URL_RE = re.compile(r"http\S+")
_HAS_TS_RE = re.compile(r"\d{1}:\d{2}")
_BAD_TS_RES = (re.compile(r"\d{3}:"), re.compile(r":\d{3}"),
               re.compile(r"\d{2}:\d{2}:\d{2}:\d{2}"))
_TS_RES = (re.compile(r"\d{2}:\d{2}:\d{2}"), re.compile(r"\d{1}:\d{2}:\d{2}"),
           re.compile(r"\d{2}:\d{2}"), re.compile(r"\d{1}:\d{2}"))


def parse_timestamp_lines(description: str) -> List[str]:
    lines = []
    for line in description.split("\n"):
        if _HAS_TS_RE.search(line):
            lines.append(_URL_RE.sub("", line))
    return lines


def extract_timestamp(s: str) -> Tuple[str, int, int, int]:
    """-> (timestamp str, seconds, span start, span end); (-1s on failure)."""
    if any(r.search(s) for r in _BAD_TS_RES):
        return "", -1, -1, -1
    for pattern in _TS_RES:
        m = pattern.search(s)
        if m:
            si, ei = m.span()
            parts = list(reversed(s[si:ei].split(":")))
            sec = sum(int(p) * (60 ** i) for i, p in enumerate(parts))
            return s[si:ei], sec, si, ei
    return "", -1, -1, -1


def clean_title(s: str) -> str:
    """Strip non-alnum characters from both ends (chapter_utils.py:48-67)."""
    alnum = [i for i, c in enumerate(s) if c.isalnum()]
    if not alnum:
        return ""
    return s[alnum[0]: alnum[-1] + 1]


def description_to_chapters(description: str) -> Optional[List[Dict]]:
    """-> [{"label", "time"}] or None (desc2chapters.py:25-38 filters)."""
    lines = parse_timestamp_lines(str(description))
    if len(lines) <= 1:
        return None
    chapters = []
    for line in lines:
        _, sec, si, ei = extract_timestamp(line)
        if sec == -1:
            continue
        title = clean_title(line[:si] + line[ei:])
        if title:
            chapters.append({"label": title, "time": sec})
    if (len(chapters) > 1
            and not all(len(c["label"].strip()) <= 1 for c in chapters)
            and all(chapters[i]["time"] < chapters[i + 1]["time"]
                    for i in range(len(chapters) - 1))):
        return chapters
    return None


def mine_chapters(descriptions: Dict[str, str]) -> Dict[str, List[Dict]]:
    """{video_id: description} -> {video_id: chapters} for videos that pass."""
    out = {}
    for vid, desc in descriptions.items():
        chapters = description_to_chapters(desc)
        if chapters is not None:
            out[vid] = chapters
    return out
