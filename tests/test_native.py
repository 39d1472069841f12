"""Native C++ data layer vs. the pure-numpy implementations: identical
outputs on FASTA parsing, pattern compression, and tip encoding."""
import os

import numpy as np
import pytest

import libpll2_jax as pll
from libpll2_jax import native
from libpll2_jax.io import compress_site_patterns, load_fasta_msa
from libpll2_jax.io.fasta import iter_fasta

pytestmark = pytest.mark.skipif(not native.ensure_native(),
                                reason="native build unavailable")


def test_compress_matches_numpy():
    rng = np.random.default_rng(3)
    seqs = ["".join("ACGT-RY"[b] for b in rng.integers(0, 7, 300))
            for _ in range(20)]
    n_out, n_w, n_map = compress_site_patterns(seqs, pll.MAP_NT,
                                               return_map=True)
    os.environ["LIBPLL2_NATIVE"] = "0"
    try:
        # force the numpy path by monkeypatching availability
        charmap_avail = native.available
        native_avail_backup = native._lib
        native._lib = None
        native._tried = True
        p_out, p_w, p_map = compress_site_patterns(seqs, pll.MAP_NT,
                                                   return_map=True)
    finally:
        native._lib = native_avail_backup
        native._tried = True
        del os.environ["LIBPLL2_NATIVE"]
        del charmap_avail
    assert n_out == p_out
    np.testing.assert_array_equal(n_w, p_w)
    np.testing.assert_array_equal(n_map, p_map)
    # weights are a partition of the sites
    assert int(n_w.sum()) == 300


def test_fasta_matches_python(tmp_path):
    text = (">seq one  \nACGT\nACG-\n\n>s2\n??AC GT*!\n"
            ">s3\nACGTACGTAC\n")
    path = tmp_path / "x.fa"
    path.write_text(text)
    labels, seqs = native.fasta_load(str(path))
    py = list(iter_fasta(str(path)))
    assert labels == [h for h, _ in py]
    assert seqs == [s for _, s in py]


def test_fasta_msa_roundtrip(tmp_path):
    rng = np.random.default_rng(11)
    recs = [(f"taxon_{i}", "".join("ACGT"[b]
                                   for b in rng.integers(0, 4, 120)))
            for i in range(40)]
    text = "".join(f">{h}\n{s[:60]}\n{s[60:]}\n" for h, s in recs)
    path = tmp_path / "m.fa"
    path.write_text(text)
    msa = load_fasta_msa(str(path))
    assert msa.labels == [h for h, _ in recs]
    assert msa.sequences == [s for _, s in recs]


def test_fasta_illegal_char(tmp_path):
    path = tmp_path / "bad.fa"
    path.write_text(">a\nAC@T\n")
    with pytest.raises(ValueError):
        native.fasta_load(str(path))


def test_encode_tip_matches_numpy():
    seq = b"ACGTRYSWKMBDHVN-acgt"
    out = native.encode_tip(seq, pll.MAP_NT)
    ref = pll.MAP_NT[np.frombuffer(seq, np.uint8)]
    np.testing.assert_array_equal(out, ref.astype(np.uint64))
    with pytest.raises(ValueError):
        native.encode_tip(b"AC@T", pll.MAP_NT)
