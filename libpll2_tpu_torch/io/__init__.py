from . import fasta, maps, phylip
from .compress import compress_site_patterns, encode_msa
from .fasta import FastaFile, FastaRecord, iter_fasta, load_fasta
from .phylip import (parse_phylip, parse_phylip_interleaved,
                     parse_phylip_sequential)
