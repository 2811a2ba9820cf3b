"""One value a line (reference ``said/util/parser.py``)."""

from __future__ import annotations

from typing import Callable, List, TypeVar

T = TypeVar("T")


def parse_list(file_path: str, typecast_func: Callable[[str], T]) -> List[T]:
    """Each line of the file, stripped, through ``typecast_func``."""
    with open(file_path, "r") as f:
        return [typecast_func(line.strip()) for line in f.readlines()]
