"""Text-file record IO (counterpart of ``singa_tpu/io/textfile.py``; the
reference's ``src/io/textfile_reader.cc`` / ``textfile_writer.cc``): a
line-per-record text store whose read key is the line number.  Files are
byte for byte those of the JAX package.

Same access API shape as ``binfile`` (count/key/value/items) plus the
reference's Open/Read/Close verbs, so scripts written against either
store port across.  Values are str; newlines inside a value are escaped
so one record is always one physical line (the reference forbids
embedded newlines instead — escaping is strictly more permissive).
"""

from __future__ import annotations

import os


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _unescape(v: str) -> str:
    out, i = [], 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append("\n" if nxt == "n" else nxt)
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


class TextFileWriter:
    def __init__(self, path, append=False):
        self.path = path
        self._f = open(path, "a" if append else "w", encoding="utf-8")
        self._n = 0

    def put(self, value: str):
        self._f.write(_escape(value) + "\n")
        self._n += 1

    # reference verb aliases
    def Write(self, key, value=None):
        """Reference signature Write(key, value); the key (line number)
        is implicit in a text store, so a single-arg call writes value."""
        self.put(value if value is not None else key)

    def Flush(self):
        self._f.flush()

    def close(self):
        self._f.close()

    Close = close

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class TextFileReader:
    def __init__(self, path):
        self.path = path
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        with open(path, "r", encoding="utf-8") as f:
            raw = f.read()
        self._lines = raw.split("\n")
        if self._lines and self._lines[-1] == "":
            self._lines.pop()
        self._cursor = 0

    def count(self) -> int:
        return len(self._lines)

    def key(self, i: int) -> str:
        return str(i)

    def value(self, i: int) -> str:
        return _unescape(self._lines[i])

    def items(self):
        for i in range(self.count()):
            yield self.key(i), self.value(i)

    def Read(self):
        """Reference-style sequential read: (key, value) or None at EOF."""
        if self._cursor >= len(self._lines):
            return None
        kv = (str(self._cursor), _unescape(self._lines[self._cursor]))
        self._cursor += 1
        return kv

    def SeekToFirst(self):
        self._cursor = 0

    def close(self):
        self._lines = []

    Close = close

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
