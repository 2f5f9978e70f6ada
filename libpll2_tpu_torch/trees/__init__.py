from . import newick, rtree, utree
from .newick import (export_newick, export_newick_rooted, parse_newick,
                     parse_newick_rooted)
from .random_tree import random_alignment, random_newick, random_utree
from .rtree import RNode, RTree
from .utree import UNode, UTree, create_operations, traverse
