from . import (derivatives, eigen, fused, gamma, levels, likelihood,
               partials, pmatrix, pool)
