from . import derivatives, eigen, fused, gamma, likelihood, pmatrix
