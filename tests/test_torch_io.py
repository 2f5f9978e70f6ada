"""Alignment I/O of the port (libpll2_tpu_torch.io: fasta, phylip,
compress) and `Partition.count_invariant_sites` against libpll2_tpu on the
CPU.

The same files, written from seeded numpy alignments (DNA and amino acids
with gaps and ambiguity codes), go through both packages' readers. Every
result is held `==`: records, headers and sequences, encoded matrices,
patterns, weights and back-maps, invariant-site counts, and the PllError
code of each malformed file."""
import numpy as np
import pytest

from libpll2_tpu import Partition as JPartition
from libpll2_tpu import constants as JC
from libpll2_tpu import io as jio
from libpll2_tpu.io import maps as jmaps

import libpll2_tpu_torch as tp
from libpll2_tpu_torch import constants as C
from libpll2_tpu_torch import io as tio
from libpll2_tpu_torch.io import maps

DNA = "ACGTACGTACGTRYKMSWN-"
AA = "ARNDCQEGHILKMFPSTWYV" * 2 + "BZJX-*"


def _alignment(n, sites, alphabet, seed):
    rng = np.random.default_rng(seed)
    chars = np.array(list(alphabet))
    return ([f"taxon_{i}" for i in range(n)],
            ["".join(row) for row in chars[rng.integers(0, len(chars),
                                                        (n, sites))]])


def _write_fasta(path, headers, seqs, width=60, case=False):
    with open(path, "w") as fh:
        for k, (h, s) in enumerate(zip(headers, seqs)):
            fh.write(f">{h} description {k}\n\n")
            for i in range(0, len(s), width):
                line = s[i:i + width]
                fh.write((line.lower() if case and i % 2 else line) + "\n")


def _write_phylip(path, headers, seqs, interleaved, width=50):
    with open(path, "w") as fh:
        fh.write(f" {len(seqs)}  {len(seqs[0])}\n")
        if interleaved:
            for i in range(0, len(seqs[0]), width):
                for h, s in zip(headers, seqs):
                    head = f"{h:<12}" if i == 0 else ""
                    chunk = s[i:i + width]
                    fh.write(head + " ".join(chunk[j:j + 10] for j in
                                             range(0, len(chunk), 10)) + "\n")
                fh.write("\n")
        else:
            for h, s in zip(headers, seqs):
                fh.write(f"{h:<12}{s[:width]}\n")
                for i in range(width, len(s), width):
                    fh.write(s[i:i + width] + "\n")


def _same_error(fn_jax, fn_port):
    with pytest.raises(JC.PllError) as je:
        fn_jax()
    with pytest.raises(C.PllError) as te:
        fn_port()
    assert te.value.errno == je.value.errno
    return te.value.errno


@pytest.mark.parametrize("alphabet,seed", [(DNA, 1), (AA, 2)])
def test_fasta_equals_jax(tmp_path, alphabet, seed):
    headers, seqs = _alignment(9, 237, alphabet, seed)
    path = str(tmp_path / "a.fas")
    _write_fasta(path, headers, seqs, width=70, case=True)
    assert tio.load_fasta(path) == jio.load_fasta(path)
    got = list(tio.iter_fasta(path))
    want = list(jio.iter_fasta(path))
    assert [(r.header, r.sequence, r.seqno) for r in got] == \
        [(r.header, r.sequence, r.seqno) for r in want]
    with tio.FastaFile(path) as tf, jio.FastaFile(path) as jf:
        assert tf.getfilesize() == jf.getfilesize()
        for _ in range(3):
            a, b = tf.getnext(), jf.getnext()
            assert (a.header, a.sequence) == (b.header, b.sequence)
            assert tf.getfilepos() == jf.getfilepos()
        tf.rewind(), jf.rewind()
        assert tf.getnext().header == jf.getnext().header == \
            f"{headers[0]} description 0"


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("alphabet,seed", [(DNA, 3), (AA, 4)])
def test_phylip_equals_jax(tmp_path, alphabet, seed, interleaved):
    headers, seqs = _alignment(7, 163, alphabet, seed)
    path = str(tmp_path / "a.phy")
    _write_phylip(path, headers, seqs, interleaved)
    got = tio.parse_phylip(path, interleaved=interleaved)
    assert got == jio.parse_phylip(path, interleaved=interleaved)
    assert got == (headers, seqs)
    form = (tio.parse_phylip_interleaved if interleaved
            else tio.parse_phylip_sequential)
    assert form(path) == got


@pytest.mark.parametrize("case", [
    "fasta_missing", "fasta_no_header", "fasta_unaligned",
    "phylip_missing", "phylip_header", "phylip_header_words",
    "phylip_long", "phylip_count", "phylip_interleaved_short"])
def test_malformed_files_raise_jax_codes(tmp_path, case):
    """Each malformed file raises the PllError code that libpll2_tpu
    raises."""
    path = str(tmp_path / "bad")
    kind, _, what = case.partition("_")
    if what != "missing":
        text = {
            "no_header": "ACGT\n>t1\nACGT\n",
            "unaligned": ">t0\nACGT\n>t1\nACG\n",
            "header": "4\nt0 ACGT\n",
            "header_words": "four 4\nt0 ACGT\n",
            "long": "2 4\nt0 ACGTA\nt1 ACGT\n",
            "count": "3 4\nt0 ACGT\nt1 ACGT\n",
            "interleaved_short": "2 8\nt0 ACGT\nt1 ACGT\nACGT\n",
        }[what]
        with open(path, "w") as fh:
            fh.write(text)
    if kind == "fasta":
        code = _same_error(lambda: jio.load_fasta(path),
                           lambda: tio.load_fasta(path))
    else:
        inter = what == "interleaved_short"
        code = _same_error(lambda: jio.parse_phylip(path, inter),
                           lambda: tio.parse_phylip(path, inter))
    assert code == {
        "missing": C.ERROR_FILE_OPEN,
        "no_header": C.ERROR_FASTA_INVALIDHEADER,
        "unaligned": C.ERROR_FASTA_NONALIGNED,
        "header": C.ERROR_PHYLIP_SYNTAX,
        "header_words": C.ERROR_PHYLIP_SYNTAX,
        "long": C.ERROR_PHYLIP_NONALIGNED,
        "count": C.ERROR_PHYLIP_SYNTAX,
        "interleaved_short": C.ERROR_PHYLIP_NONALIGNED}[what]


@pytest.mark.parametrize("mapname,alphabet,seed,taxa,sites", [
    ("map_nt", DNA, 5, 8, 500), ("map_nt", "ACGT", 6, 4, 400),
    ("map_aa", AA, 7, 5, 300), ("map_bin", "01-", 8, 6, 200),
    ("map_gt10", "ACGTMRWSYK-", 9, 5, 250)])
def test_compression_equals_jax(mapname, alphabet, seed, taxa, sites):
    """encode_msa and compress_site_patterns (patterns, weights, back-map)
    `==` JAX's (after tests/test_compress_m3.py:37-67); the back-map
    rebuilds the columns."""
    _, seqs = _alignment(taxa, sites, alphabet, seed)
    jmap, tmap = getattr(jmaps, mapname), getattr(maps, mapname)
    np.testing.assert_array_equal(tio.encode_msa(seqs, tmap),
                                  jio.encode_msa(seqs, jmap))
    got = tio.compress_site_patterns(seqs, tmap, return_map=True)
    want = jio.compress_site_patterns(seqs, jmap, return_map=True)
    assert got[0] == want[0]
    assert got[1].dtype == want[1].dtype and got[2].dtype == want[2].dtype
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert int(got[1].sum()) == sites
    comp = np.array([maps.decode_states(s, tmap) for s in got[0]])
    full = np.array([maps.decode_states(s, tmap) for s in seqs])
    np.testing.assert_array_equal(comp[:, got[2]], full)
    assert tio.compress_site_patterns(seqs, tmap)[2] is None


def test_compression_errors_equal_jax():
    _, seqs = _alignment(3, 20, "ACGT", 10)
    bad = [seqs[0], seqs[1][:-1] + "!", seqs[2]]
    for fn in ("encode_msa", "compress_site_patterns"):
        code = _same_error(lambda: getattr(jio, fn)(bad, jmaps.map_nt),
                           lambda: getattr(tio, fn)(bad, maps.map_nt))
        assert code == C.ERROR_TIPDATA_ILLEGALSTATE
        short = [seqs[0], seqs[1][:-1], seqs[2]]
        code = _same_error(lambda: getattr(jio, fn)(short, jmaps.map_nt),
                           lambda: getattr(tio, fn)(short, maps.map_nt))
        assert code == C.ERROR_FASTA_NONALIGNED


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("states,alphabet,mapname", [
    (4, "AAAACGT-N", "map_nt"), (20, "AAAAARNDX-", "map_aa")])
def test_count_invariant_sites_equals_jax(compressed, states, alphabet,
                                          mapname):
    """count_invariant_sites `==` JAX's, on raw columns and on compressed
    patterns with their weights; detection reruns after a tip setter."""
    n, sites = 6, 180
    _, seqs = _alignment(n, sites, alphabet, 11)
    seqs = ["A" * 40 + s[40:] for s in seqs]           # invariant columns
    weights = None
    if compressed:
        seqs, weights, _ = tio.compress_site_patterns(
            seqs, getattr(maps, mapname))
    width = len(seqs[0])
    jp = JPartition(n, n - 2, states, width, 1, 2 * n - 3, 1, n - 2)
    part = tp.Partition(n, n - 2, states, width, 1, 2 * n - 3, 1, n - 2,
                        device="cpu")
    for p, cm in ((jp, getattr(jmaps, mapname)),
                  (part, getattr(maps, mapname))):
        for i, s in enumerate(seqs):
            p.set_tip_states(i, cm, s)
        if weights is not None:
            p.set_pattern_weights(weights)
    got = part.count_invariant_sites()
    assert got == jp.count_invariant_sites() and got >= 40
    np.testing.assert_array_equal(part.invariant, jp.invariant)
    k = int(np.flatnonzero(part.invariant[:width] >= 0)[0])
    other = "C" if states == 4 else "R"
    seq = seqs[0][:k] + other + seqs[0][k + 1:]
    part.set_tip_states(0, getattr(maps, mapname), seq)
    jp.set_tip_states(0, getattr(jmaps, mapname), seq)
    assert part.count_invariant_sites() == jp.count_invariant_sites() \
        < got


def test_count_invariant_sites_none_found():
    """No invariant column: both raise ERROR_INVAR_NONEFOUND."""
    seqs = ["ACGTAC", "CGTACG", "GTACGT", "TACGTA"]
    parts = []
    for P, cm, kw in ((JPartition, jmaps.map_nt, {}),
                      (tp.Partition, maps.map_nt, {"device": "cpu"})):
        p = P(4, 2, 4, 6, 1, 5, 1, 2, **kw)
        for i, s in enumerate(seqs):
            p.set_tip_states(i, cm, s)
        parts.append(p)
    code = _same_error(parts[0].count_invariant_sites,
                       parts[1].count_invariant_sites)
    assert code == C.ERROR_INVAR_NONEFOUND
