"""Op lists for the level kernel's tests (test_torch_levels.py on the CPU,
test_torch_cuda.py on the card). Imports nothing but the standard library,
so that the card's tests, which run without jax, can use it."""
import copy


def self_child_op(ops, n_tips):
    """One op that writes its own child1 in place (CLV and scaler row):
    the last op of `ops` whose child1 is an inner node, its parent rows
    redirected to that child's."""
    op = copy.copy(next(o for o in reversed(ops)
                        if o.child1_clv_index >= n_tips))
    op.parent_clv_index = op.child1_clv_index
    op.parent_scaler_index = op.child1_scaler_index
    return op
