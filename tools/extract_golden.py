#!/usr/bin/env python
"""Extract golden test vectors from the reference's autotest data files.

The reference (liquid-dsp) stores regression vectors as plain C arrays in
``src/<module>/tests/data/*.c`` (e.g. ``firfilt_crcf_data_h13x32.c`` declares
``..._h``, ``..._x`` and ``..._y`` arrays).  These are numeric test *data*
generated by Octave scripts — we parse them into ``.npz`` files so pytest can
assert our implementation matches the reference outputs within the
reference tolerance (tol=0.001, see reference src/filter/tests/firfilt_runtest.c:40).

Usage:  python tools/extract_golden.py [--ref /root/reference] [--out tests/golden]
"""
import argparse
import pathlib
import re
import sys

import numpy as np

# matches: float name[] = { ... };   and   float complex name[] = { ... };
_ARRAY_RE = re.compile(
    r"(?P<type>float complex|float|liquid_float_complex)\s+"
    r"(?P<name>\w+)\s*\[\s*\]\s*=\s*\{(?P<body>.*?)\}\s*;",
    re.DOTALL,
)
# complex literal: a + b*_Complex_I  (b may carry its own sign)
_CPLX_RE = re.compile(
    r"([+-]?\s*[\d.eE+-]+)\s*\+\s*([+-]?\s*[\d.eE+-]+)\s*\*\s*_Complex_I"
)


def _parse_float(tok: str) -> float:
    return float(tok.replace(" ", ""))


_COMMENT_RE = re.compile(r"/\*.*?\*/|//[^\n]*", re.DOTALL)


def parse_c_arrays(text: str) -> dict:
    """Parse all float / float-complex array declarations in a C source."""
    text = _COMMENT_RE.sub("", text)
    out = {}
    for m in _ARRAY_RE.finditer(text):
        name, body = m.group("name"), m.group("body")
        if "_Complex_I" in body:
            vals = [
                complex(_parse_float(re_), _parse_float(im))
                for re_, im in _CPLX_RE.findall(body)
            ]
            out[name] = np.asarray(vals, dtype=np.complex64)
        else:
            toks = [t.strip() for t in body.split(",") if t.strip()]
            out[name] = np.asarray([_parse_float(t) for t in toks], dtype=np.float32)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref", default="/root/reference")
    ap.add_argument("--out", default=str(pathlib.Path(__file__).parent.parent / "tests/golden"))
    args = ap.parse_args()

    ref = pathlib.Path(args.ref)
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    n_files = 0
    for cfile in sorted(ref.glob("src/*/tests/data/*.c")):
        arrays = parse_c_arrays(cfile.read_text(errors="replace"))
        if not arrays:
            continue
        np.savez(outdir / (cfile.stem + ".npz"), **arrays)
        n_files += 1
    print(f"extracted {n_files} golden data files -> {outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
