"""FASTA/PHYLIP parsing and site-pattern compression.

The compression invariant test mirrors the reference's guarantee: the
compressed (patterns, weights) partition must yield EXACTLY the same logL
as the uncompressed one (compress.c semantics + per-site weighted sum)."""
import numpy as np
import pytest

import libpll2_jax as pll
from libpll2_jax.io import (MSA, compress_site_patterns, load_fasta_string,
                            load_phylip_string)

FASTA = """>taxon1 first
ACGT-ACG
TACG
> taxon2
ACGTTACG
TACG
>taxon3
ACGAAACG
TACG
"""

PHYLIP_SEQ = """3 12
taxon1  ACGT-ACG
TACG
taxon2  ACGTTACGTACG
taxon3  ACGAAACG TACG
"""

PHYLIP_INT = """ 3 12 i
taxon1  ACGT-ACG
taxon2  ACGTTACG
taxon3  ACGAAACG

TACG
TACG
TACG
"""


def test_fasta():
    msa = load_fasta_string(FASTA)
    assert msa.labels == ["taxon1 first", "taxon2", "taxon3"]
    assert msa.sequences[0] == "ACGT-ACGTACG"
    assert msa.count == 3 and msa.length == 12


def test_phylip_sequential():
    msa = load_phylip_string(PHYLIP_SEQ, interleaved=False)
    assert msa.labels == ["taxon1", "taxon2", "taxon3"]
    assert msa.sequences == ["ACGT-ACGTACG", "ACGTTACGTACG", "ACGAAACGTACG"]


def test_phylip_interleaved():
    msa = load_phylip_string(PHYLIP_INT, interleaved=True)
    assert msa.sequences == ["ACGT-ACGTACG", "ACGTTACGTACG", "ACGAAACGTACG"]


def test_phylip_misaligned():
    bad = "2 8\nt1 ACGTACGT\nt2 ACGTA\n"
    with pytest.raises(ValueError):
        load_phylip_string(bad, interleaved=False)


def test_compress_basic():
    seqs = ["ACCA", "AGGA", "ATTA"]
    out, w = compress_site_patterns(seqs, pll.MAP_NT)
    # columns: (A,A,A), (C,G,T), (C,G,T), (A,A,A) -> 2 patterns, weights 2,2
    assert len(out[0]) == 2
    assert sorted(w.tolist()) == [2, 2]
    assert sum(w) == 4


def test_compress_map_roundtrip():
    seqs = ["ACGTACGT", "ACGTACGA", "CCGTACGT"]
    out, w, smap = compress_site_patterns(seqs, pll.MAP_NT, return_map=True)
    # reconstruct original from patterns + map
    for row, orig in zip(out, seqs):
        rebuilt = "".join(row[k] for k in smap)
        assert rebuilt == orig
    assert w.sum() == len(seqs[0])


def test_compress_gap_canonical():
    # '?' and '-' both map to the gap state; decode must emit '-'
    seqs = ["A?", "A-"]
    out, w = compress_site_patterns(seqs, pll.MAP_NT)
    assert out[0] == "A-"[:len(out[0])] or "-" in out[0] + out[1]


def rand_case(n_tips=6, sites=200, seed=11):
    rng = np.random.default_rng(seed)
    alphabet = "ACGT-RY"
    seqs = ["".join(rng.choice(list(alphabet), sites)) for _ in range(n_tips)]
    return seqs


def logl_for(seqs, weights=None):
    n, sites = len(seqs), len(seqs[0])
    p = pll.Partition(n, n - 1, 4, sites, 1, 2 * n - 2, 4, n - 1)
    p.set_frequencies(0, [0.3, 0.25, 0.2, 0.25])
    p.set_subst_params(0, [1.2, 2.1, 0.7, 1.3, 2.5, 1.0])
    p.set_gamma_rates(0.9)
    if weights is not None:
        p.set_pattern_weights(weights)
    for i, s in enumerate(seqs):
        p.set_tip_states(i, pll.MAP_NT, s)
    # caterpillar operations
    ops = []
    bl = []
    mi = []
    prev = 0
    for k in range(1, n):
        parent = n + k - 1
        ops.append(pll.Operation(parent, prev, k, 2 * (k - 1),
                                 2 * (k - 1) + 1, k - 1, -1 if prev < n
                                 else prev - n, -1))
        bl += [0.1 + 0.01 * k, 0.2 + 0.02 * k]
        mi += [2 * (k - 1), 2 * (k - 1) + 1]
        prev = parent
    p.update_prob_matrices([0] * 4, mi, bl)
    p.update_partials(ops)
    return p.compute_root_loglikelihood(prev, n - 2, [0] * 4)


def test_compress_logl_equivalence():
    seqs = rand_case()
    out, w = compress_site_patterns(seqs, pll.MAP_NT)
    full = logl_for(seqs)
    comp = logl_for(out, w)
    np.testing.assert_allclose(comp, full, rtol=1e-12)


def test_fasta_streaming_reader(tmp_path):
    """FastaFile: record-at-a-time getnext with rewind/position
    (pll_fasta_open/getnext/rewind/getfilepos, fasta.c:40-326)."""
    from libpll2_jax.io import FastaFile

    path = tmp_path / "msa.fa"
    path.write_text(FASTA)
    with FastaFile(str(path)) as fd:
        assert fd.filesize == len(FASTA)
        r1 = fd.getnext()
        assert r1 == ("taxon1 first", "ACGT-ACGTACG", 1)
        assert 0 < fd.getfilepos() <= fd.filesize
        r2 = fd.getnext()
        assert r2 == ("taxon2", "ACGTTACGTACG", 2)
        assert fd.getnext() == ("taxon3", "ACGAAACGTACG", 3)
        assert fd.getnext() is None
        # whitespace stripping is counted per char code (fd->stripped)
        assert fd.stripped_count > 0 and fd.stripped.get("\n", 0) > 0
        fd.rewind()
        assert fd.getnext() == r1
        # iterator protocol resumes from the current record
        assert [h for h, _ in fd] == ["taxon2", "taxon3"]


def test_fasta_streaming_errors(tmp_path):
    from libpll2_jax.io import FastaFile
    from libpll2_jax.io.fasta import FastaError

    bad = tmp_path / "bad.fa"
    bad.write_text("ACGT\n>x\nACGT\n")
    with FastaFile(str(bad)) as fd:
        with pytest.raises(FastaError):
            fd.getnext()
    bad2 = tmp_path / "bad2.fa"
    bad2.write_text(">x\nAC{T\n")
    with FastaFile(str(bad2)) as fd:
        with pytest.raises(FastaError):
            fd.getnext()
