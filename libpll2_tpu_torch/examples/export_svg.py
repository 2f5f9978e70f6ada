"""Tree visualization: SVG and ASCII export (reference: examples/svg/;
port of examples/export_svg.py). Host code only: `--device` is accepted
for a uniform command line and not used.

Usage: python -m libpll2_tpu_torch.examples.export_svg [out.svg]"""
from __future__ import annotations

from ..trees import export_svg, parse_newick
from ..utils import show_tree_ascii
from ._cli import parser

NEWICK = ("((t0:0.10,t1:0.22):0.05,(t2:0.30,(t3:0.12,t4:0.15):0.20):0.10,"
          "t5:0.40);")


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("out", nargs="?", default="tree.svg",
                    help="the SVG file to write (default tree.svg in the "
                    "working directory)")
    args = ap.parse_args(argv)
    tree = parse_newick(NEWICK)
    show_tree_ascii(tree.vroot)
    svg = export_svg(tree.vroot)
    with open(args.out, "w") as f:
        f.write(svg)
    print(f"wrote {args.out} ({len(svg)} bytes)")


if __name__ == "__main__":
    main()
