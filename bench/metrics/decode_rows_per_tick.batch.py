"""Tokens the window's decode steps produced over the ticks that decoded."""

from harness.readers import decode_rows_per_tick


def read(r):
    return decode_rows_per_tick(r)
