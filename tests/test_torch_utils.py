"""The port's utilities (libpll2_tpu_torch/utils/, trees/svg.py) against
libpll2_tpu's, on the CPU: the hardware probe and its dump, the printers
(`show_pmatrix`, `show_clv` dense and on a site-repeats partition,
`show_tree_ascii`), whose strings must equal JAX's on float64 partitions
built from the same inputs, `export_svg` (equal to JAX's document with the
default and a custom `SvgAttrib`), and the profiling hooks (`trace` writes
a trace, `annotate` names a range in it, `time_fn` times a call)."""
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpll2_tpu as jx
from libpll2_tpu import utils as jutils
from libpll2_tpu.io import maps as jmaps
from libpll2_tpu.trees import SvgAttrib as JSvgAttrib
from libpll2_tpu.trees import create_operations as jcreate_operations
from libpll2_tpu.trees import export_svg as jexport_svg
from libpll2_tpu.trees import parse_newick as jparse
from libpll2_tpu.trees import traverse as jtraverse

import libpll2_tpu_torch as tp
from libpll2_tpu_torch import utils as tutils
from libpll2_tpu_torch.io import maps as tmaps
from libpll2_tpu_torch.trees import SvgAttrib, export_svg
from libpll2_tpu_torch.trees import create_operations as tcreate_operations
from libpll2_tpu_torch.trees import parse_newick as tparse
from libpll2_tpu_torch.trees import traverse as ttraverse

CPU = torch.device("cpu")
NEWICK = ("((t0:0.10,t1:0.22):0.05,(t2:0.30,(t3:0.12,t4:0.15):0.20):0.10,"
          "t5:0.40);")
SEQS = ["ACGTACGTAACCGGTTACGT", "ACGTACGAACCCGGTTACGA",
        "ACCTACGTAACCGATTACGT", "ACGTTCGTAACCGGTAACGT",
        "GCGTACGTAACCGGTTACTT", "ACGTACGGAACCGGTTTCGT"]


def _partitions(repeats=False):
    """The same 6-taxon alignment and GTR+G4 model in both packages, in
    float64, with every CLV of the postorder computed."""
    out = []
    for pkg, maps, parse, trav, ops_of, kw in (
            (jx, jmaps, jparse, jtraverse, jcreate_operations,
             {"dtype": jnp.float64}),
            (tp, tmaps, tparse, ttraverse, tcreate_operations,
             {"dtype": torch.float64, "device": CPU})):
        tree = parse(NEWICK)
        part = pkg.Partition(tree.tip_count, tree.inner_count, 4,
                             len(SEQS[0]), 1, tree.edge_count, 2,
                             tree.inner_count, site_repeats=repeats, **kw)
        for tip in tree.tips():
            part.set_tip_states(tip.clv_index, maps.map_nt,
                                SEQS[int(tip.label[1:])])
        part.set_frequencies(0, [0.3, 0.2, 0.2, 0.3])
        part.set_subst_params(0, [1.0, 2.5, 0.8, 1.1, 2.5, 1.0])
        part.set_category_rates(pkg.compute_gamma_cats(0.7, 2))
        ops, branches, pidx = ops_of(trav(tree.vroot))
        part.update_prob_matrices([0, 0], pidx, branches)
        part.update_partials(ops)
        out.append((part, tree, ops))
    return out


def _printed(fn, *args, **kw):
    buf = io.StringIO()
    fn(*args, file=buf, **kw)
    return buf.getvalue()


def test_probe_and_dump_on_cpu():
    info = tutils.probe()
    assert info.platform == "cpu" and info.device_kind == "cpu"
    assert (info.device_count, info.local_device_count,
            info.process_count) == (1, 1, 1)
    assert set(vars(info)) == set(vars(jutils.probe()))
    text = _printed(tutils.dump)
    assert text == ("platform: cpu\ndevice kind: cpu\n"
                    "devices: 1 (1 local, 1 processes)\n")


@pytest.mark.parametrize("precision", [4, 7])
def test_show_pmatrix_equals_jax(precision):
    (jp, _, _), (tpart, _, _) = _partitions()
    for index in (0, 3, 8):
        want = _printed(jutils.show_pmatrix, jp, index,
                        float_precision=precision)
        assert _printed(tutils.show_pmatrix, tpart, index,
                        float_precision=precision) == want


@pytest.mark.parametrize("repeats", [False, True])
def test_show_clv_equals_jax(repeats):
    """Every inner CLV, dense and through a repeats partition's site_id."""
    (jp, _, jops), (tpart, _, tops) = _partitions(repeats)
    if repeats:
        assert jp.repeats is not None and tpart.repeats is not None
    for jo, to in zip(jops, tops):
        want = _printed(jutils.show_clv, jp, jo.parent_clv_index)
        got = _printed(tutils.show_clv, tpart, to.parent_clv_index)
        assert got == want
    assert _printed(tutils.show_clv, tpart, 0, float_precision=2) == \
        _printed(jutils.show_clv, jp, 0, float_precision=2)


@pytest.mark.parametrize("newick", [
    NEWICK, "((A:0.1,B:0.2):0.05,(C:0.3,D:0.1):0.07,E:0.15);",
    "(a:1,b:2,(c:3,(d:4,(e:5,f:6)x:1)y:2)z:3);"])
def test_show_tree_ascii_equals_jax(newick):
    jtree, ttree = jparse(newick), tparse(newick)
    assert _printed(tutils.show_tree_ascii, ttree.vroot) == \
        _printed(jutils.show_tree_ascii, jtree.vroot)
    tip = next(iter(ttree.tips()))
    jtip = next(iter(jtree.tips()))
    assert _printed(tutils.show_tree_ascii, tip) == \
        _printed(jutils.show_tree_ascii, jtip)


@pytest.mark.parametrize("attrib", [
    None, dict(width=640, font_size=9, tip_spacing=15, stroke_width=1.5,
               legend_ratio=0.25, margin_left=7, precision=3),
    dict(legend_show=False, node_radius=2.0)])
def test_export_svg_equals_jax(attrib):
    jtree, ttree = jparse(NEWICK), tparse(NEWICK)
    want = jexport_svg(jtree.vroot,
                       JSvgAttrib(**attrib) if attrib else None)
    got = export_svg(ttree.vroot, SvgAttrib(**attrib) if attrib else None)
    assert got == want
    assert vars(SvgAttrib()) == vars(JSvgAttrib())


def test_trace_writes_a_trace_with_the_engine_scopes(tmp_path):
    (_, _, _), (tpart, ttree, _) = _partitions()
    eng = tp.TreeEngine(tpart, ttree)
    eng.loglikelihood()
    with tutils.trace(str(tmp_path)):
        with tutils.annotate("outer.block"):
            eng.loglikelihood()
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert files
    with open(tmp_path / files[0]) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"outer.block", "pll.pmatrix", "pll.fused_traversal",
            "pll.edge_logl"} <= names


def test_annotate_outside_a_profiler_and_time_fn():
    with tutils.annotate("nothing.recorded"):
        x = torch.ones(3).sum()
    assert float(x) == 3.0
    t = tutils.time_fn(lambda: torch.randn(64, 64) @ torch.randn(64, 64),
                       iters=3)
    assert 0.0 < t < 10.0
