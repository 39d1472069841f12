"""Extract the empirical amino-acid model tables (exchangeability rates and
stationary frequencies) from the reference's maps.c into an .npz artifact.

These are published scientific model constants (Dayhoff 1978 ... Q.* 2021),
identical in every phylogenetics package; we extract the *data*, the code
around it is ours.  Source: /root/reference/src/maps.c:265-1755.
"""
from __future__ import annotations

import re
import sys
from pathlib import Path

import numpy as np

REF = Path("/root/reference/src/maps.c")
OUT = Path(__file__).resolve().parent.parent / \
    "libpll2_jax/models/data/aa_tables.npz"


def main() -> None:
    text = REF.read_text()
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)  # strip C comments
    text = re.sub(r"//[^\n]*", " ", text)
    # match: const double pll_aa_<kind>_<name>[...]([...])? = { numbers };
    pat = re.compile(
        r"const double pll_aa_(rates|freqs)_(\w+)\s*((?:\[\d+\])+)\s*=\s*"
        r"\{(.*?)\};", re.S)
    arrays: dict[str, np.ndarray] = {}
    for kind, name, dims, body in pat.findall(text):
        nums = np.array([float(x) for x in
                         re.findall(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?", body)])
        shape = tuple(int(d) for d in re.findall(r"\[(\d+)\]", dims))
        assert nums.size == int(np.prod(shape)), (name, nums.size, shape)
        arrays[f"{kind}_{name}"] = nums.reshape(shape)

    names = sorted({k.split("_", 1)[1] for k in arrays})
    for n in names:
        assert f"rates_{n}" in arrays and f"freqs_{n}" in arrays, n

    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} with {len(names)} models: {', '.join(names)}")


if __name__ == "__main__":
    sys.exit(main())
