from . import moves, newick, rtree, utils, utree
from .moves import (Rollback, nni, nni_neighbours, rollback_move, spr,
                    utree_find)
from .newick import (export_newick, export_newick_rooted, parse_newick,
                     parse_newick_rooted)
from .random_tree import random_alignment, random_newick, random_utree
from .rtree import RNode, RTree
from .svg import SvgAttrib, export_svg
from .utils import (check_integrity, edge_support, graph_clone,
                    majority_rule_consensus, prune_tip, rf_distance,
                    rtree_unroot, tree_bipartitions, utree_clone)
from .utree import (UNode, UTree, compile_levels, create_operations,
                    traverse)
