"""Model optimization: branch lengths, exchangeabilities, frequencies, the
Gamma shape and p-inv, in PyTorch.

Port of libpll2_tpu/optimize.py, the loop that RAxML-NG and ModelTest-NG
wrap around the engine. Two routes, as in JAX:

  * the gradient route (`make_loglikelihood_fn`, `maximize_loglikelihood`
    and `adam_ascent` on a `pallas=False` engine): the whole likelihood --
    the rate matrix, P-matrices as a matrix function of it
    (ops/pmatrix.py:update_prob_matrices_sym, whose derivative holds at
    the repeated eigenvalues of JC, K80 and HKY, where JAX's masked eigh
    derivative does not: ROADMAP C), the pruning recursion
    (ops/partials.py:update_partials_functional, out of place), scaling and
    rate mixing -- is plain PyTorch, differentiated by torch.autograd. No
    kernel has a backward (JAX's Pallas kernels have none either), so this
    route runs the plain ops, on the card too;
  * the trial route (`make_fused_loglikelihood_fn`, `maximize_fused`) on a
    kernel engine: a central-difference Adam whose 2n+1 trial models a
    step are scored on the engine's own path
    (`TreeEngine._trial_loglikelihoods`: one launch of the fused kernel's
    candidate form a chunk of 128 trials on 'fused' and
    'repeats-dense-fused'; the trial form of the level kernel, one launch
    a level a chunk, on 'levels-kernel', and of the pool kernel, one launch
    a traversal a chunk at 4 states x 4 rates and one a level otherwise, on
    'pool-pallas'; a chunk there is as many trials as
    engine.py:TRIAL_LAUNCH_BYTES of trial buffers hold).

Branch lengths on a kernel engine go to `newton_smooth_all`
(ops/branch_sweep.py: each step's CLV op a one-op level of the level
kernel) or the step-by-step `newton_optimize_branches`; the Gamma shape and
p-inv to Brent (`optimize_gamma_shape`, `optimize_pinv`), one
`loglikelihood()` an evaluation on the engine's path.

Parameterization (unconstrained), with JAX's flat order (`ravel_pytree`:
keys sorted, each row-major): `freq_logits` (softmax), `log_branches`,
`log_subst` (the last rate pinned to 1, or class 0 of a `subst_template`).
Adam is written out as `optax.adam`'s defaults compute it (b1 0.9, b2 0.999,
eps 1e-8, eps_root 0). JAX's `lax.scan` over a chunk of steps is a Python
loop here: `chunk` keeps its meaning (the early-stop check runs between
chunks, so the history has JAX's length), and the chunk's logLs come to
the host once.
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from . import constants as C
from .engine import TreeEngine, _on_device, _pmatrices
from .parallel.sharding import replicated_input
from .ops import eigen as ops_eigen
from .ops import likelihood as ops_likelihood
from .ops import partials as ops_partials
from .ops import pmatrix as ops_pmatrix

__all__ = ["make_loglikelihood_fn", "maximize_loglikelihood",
           "make_fused_loglikelihood_fn", "maximize_fused", "adam_ascent",
           "newton_smooth_all", "newton_optimize_branches",
           "optimize_gamma_shape", "optimize_pinv"]

# optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _build_params(engine: TreeEngine, optimize: Iterable[str],
                  subst_template=None) -> Dict[str, torch.Tensor]:
    """The start of the selected groups, in the partition's dtype on its
    device (libpll2_tpu/optimize.py:39-87)."""
    p = engine.partition
    dev, d = engine.device, p.dtype
    params: Dict[str, torch.Tensor] = {}
    if "branches" in optimize:
        blen = torch.clamp(engine.branches, min=C.OPT_MIN_BRANCH_LEN)
        params["log_branches"] = torch.log(blen).to(d)
    if "subst" in optimize:
        if subst_template is not None:
            tmpl = np.asarray(subst_template, np.int32)
            n_free = int(tmpl.max())
            # every class 0..n_free must be non-empty: class 0 is the
            # pinned reference rate the others are expressed against, and
            # an empty class's warm start would be the mean of an empty
            # slice (silent NaN optimization)
            missing = [c for c in range(n_free + 1)
                       if not np.any(tmpl == c)]
            if missing:
                raise C.PllError(
                    C.ERROR_PARAM_INVALID,
                    f"subst_template must use every class id 0..{n_free} "
                    f"at least once (class 0 is the pinned reference "
                    f"rate); missing: {missing}")
            if n_free > 0:
                # warm-start each class from the partition's CURRENT
                # rates; fall back to a small spread when the rates sit at
                # the all-equal point, where eigh's spectrum is degenerate
                cur = np.maximum(np.asarray(p.subst_params, np.float64),
                                 1e-9)
                base = np.array([cur[:, tmpl == 0].mean(axis=1)]).T
                init = np.stack(
                    [np.log(cur[:, tmpl == c].mean(axis=1) / base[:, 0])
                     for c in range(1, n_free + 1)], axis=1)
                flat = np.abs(init) < 1e-3
                init[flat] = np.tile(np.linspace(0.08, 0.25, n_free),
                                     (p.rate_matrices, 1))[flat]
                params["log_subst"] = torch.tensor(init, dtype=d, device=dev)
        else:
            rates = np.maximum(p.subst_params, 1e-6)
            rates = rates / rates[:, -1:]
            params["log_subst"] = torch.tensor(np.log(rates[:, :-1]),
                                               dtype=d, device=dev)
    if "freqs" in optimize:
        params["freq_logits"] = torch.tensor(
            np.log(np.maximum(p.frequencies, 1e-10)), dtype=d, device=dev)
    return params


def _make_subst_expander(p, subst_template, dtype, device):
    """expand(params) -> [..., M, slots] full exchangeability rates from the
    free log-rates (with any leading trial axes), honouring an optional
    class template (class 0 pinned to 1). Shared by the gradient and the
    trial routes."""
    base_subst = torch.tensor(p.subst_params, dtype=dtype, device=device)
    tmpl = (None if subst_template is None else torch.as_tensor(
        np.asarray(subst_template, np.int64), device=device))

    def expand(params):
        if "log_subst" not in params:
            if tmpl is not None:
                # all classes pinned (e.g. JC/F81): every rate is 1
                return torch.ones_like(base_subst)
            return base_subst
        free = torch.exp(params["log_subst"])
        one = torch.ones(free.shape[:-1] + (1,), dtype=free.dtype,
                         device=free.device)
        if tmpl is not None:
            return torch.cat([one, free], dim=-1)[..., tmpl]
        return torch.cat([free, one], dim=-1)

    return expand


def _check_template(p, subst_template):
    if subst_template is None:
        return None
    subst_template = np.asarray(subst_template, np.int32)
    if subst_template.shape != (p.subst_params.shape[1],):
        raise C.PllError(C.ERROR_PARAM_INVALID,
                         "subst_template must cover every rate slot")
    return subst_template


def make_loglikelihood_fn(engine: TreeEngine,
                          optimize: Iterable[str] = ("branches",),
                          subst_template=None):
    """Returns (fn, params0): fn(params) -> logL (a 0-d tensor),
    differentiable by torch.autograd.

    `subst_template` (int array over the upper-triangle rate slots) ties
    exchangeability rates into classes for NESTED substitution models:
    class 0 is pinned to rate 1, classes 1..n map to free log-rates --
    e.g. DNA HKY is [0, 1, 0, 0, 1, 0], GTR is [1, 2, 3, 4, 5, 0]. Only the
    plain paths ('levels', 'scan') are differentiable: build the engine
    with pallas=False. The partition's buffers are not written.

    On a sharded partition fn runs the plain path once a shard, on each
    shard's block from the replicated P-matrices, and sums the shards'
    partial sums (parallel/sharding.py:psum); under several processes the
    parameters' gradient is summed over them (`replicated_input`), as JAX
    differentiates through its psums."""
    p = engine.partition
    d = p.dtype
    optimize = tuple(optimize)
    subst_template = _check_template(p, subst_template)
    units = engine._units()
    if engine.use_pallas or engine.repeats_dense_fused:
        raise ValueError("build the TreeEngine with pallas=False for "
                         "gradient optimization (or use maximize_fused / "
                         "maximize_loglikelihood, which run model-parameter "
                         "optimization on the fused kernels directly)")
    if units[0].partition.clv is None:
        raise C.PllError(
            C.ERROR_PARAM_INVALID,
            "gradient optimization runs over dense CLV buffers; pooled "
            "site-repeats partitions are not differentiable — build the "
            "partition without site_repeats (the fused engine keeps the "
            "speed either way)")
    (eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates, rate_weights,
     base_freqs, pidx) = engine._model_args()
    ops, valid = engine._ops if engine.levels else (engine._ops, None)
    # each shard's (or the partition's) buffers, site data, plan and modes
    blocks = [(u.partition.clv, u.partition.scale_buffer, *u._site_args(),
               _on_device((ops, valid), u.device), u.partition._modes())
              for u in units]
    p_clv, p_sc, c_clv, c_sc, root_mat = engine.root_idx

    expand_subst = _make_subst_expander(p, subst_template, d, engine.device)
    params0 = _build_params(engine, optimize, subst_template)
    model_varies = "log_subst" in params0 or "freq_logits" in params0
    if subst_template is not None and not model_varies:
        # e.g. JC with fixed frequencies: the tied model is a constant
        tmpl_eigen = ops_eigen.update_eigen_torch(expand_subst({}),
                                                  base_freqs)

    def fn(params: Dict[str, torch.Tensor]) -> torch.Tensor:
        params = {k: replicated_input(v, p.mesh) for k, v in params.items()}
        freqs = (torch.softmax(params["freq_logits"], dim=-1)
                 if "freq_logits" in params else base_freqs)
        branches = (torch.exp(params["log_branches"])
                    if "log_branches" in params else engine.branches)
        if model_varies:
            pmatrix = ops_pmatrix.update_prob_matrices_sym(
                ops_eigen.rate_matrix_sym_torch(expand_subst(params), freqs),
                freqs, prop_invar, rates, pidx, branches)
        else:
            ev, evecs, ivecs = (tmpl_eigen if subst_template is not None
                                else (eigenvals, eigenvecs, inv_eigenvecs))
            pmatrix = _pmatrices(ev, ivecs, evecs, prop_invar, rates, pidx,
                                 branches)
        totals = []
        for clv0, sc0, pw, invariant, (ops_b, valid_b), modes in blocks:
            dev = clv0.device
            pm = pmatrix.to(dev)
            clv, sc = ops_partials.update_partials_functional(
                clv0, sc0, pm, ops_b, valid_b, p.scale_threshold,
                p.scale_factor, rate_scalers=p.rate_scalers)
            totals.append(ops_likelihood.edge_loglikelihood(
                clv[p_clv], clv[c_clv], sc[p_sc], sc[c_sc], pm[root_mat],
                freqs.to(dev), prop_invar.to(dev), rate_weights.to(dev),
                pidx.to(dev), pw, invariant, p.scale_threshold,
                **modes)[0])
        if engine._shards is None:
            return totals[0]
        return engine._shards.reduce(totals)

    return fn, params0


def maximize_loglikelihood(engine: TreeEngine,
                           optimize: Iterable[str] = ("branches",),
                           steps: int = 200,
                           learning_rate: float = 0.02,
                           tol: float = 1e-6,
                           patience: int = 25,
                           chunk: int = 25,
                           subst_template=None):
    """Adam ascent on logL over the selected parameter groups.

    Runs `chunk` Adam steps between early-stop checks; stops only after
    `patience` consecutive steps without a tol-improvement of the best logL
    (Adam is non-monotone). Returns (final logL, params, history); the
    best-seen parameters are applied back to the engine and partition.

    On a kernel engine ('fused', 'levels-kernel', 'repeats-dense-fused')
    model-parameter groups route to `maximize_fused`: the kernels are not
    differentiable, so the gradient there is a batched central difference.
    Branch lengths on such engines belong to `newton_smooth_all`."""
    if engine.use_pallas or engine.repeats_dense_fused:
        if "branches" in tuple(optimize):
            raise C.PllError(
                C.ERROR_PARAM_INVALID,
                "branch lengths on a Pallas-path engine are optimized by "
                "the fused Newton machinery (newton_smooth_all / "
                "TreeEngine.newton_loop); maximize() on this engine "
                "covers the model groups ('subst', 'freqs') only")
        return maximize_fused(engine, optimize, steps=steps,
                              learning_rate=learning_rate, tol=tol,
                              patience=patience, chunk=chunk,
                              subst_template=subst_template)
    fn, params = make_loglikelihood_fn(engine, optimize,
                                       subst_template=subst_template)
    final, best_params, history = adam_ascent(
        fn, params, steps=steps, learning_rate=learning_rate, tol=tol,
        patience=patience, chunk=chunk)
    _apply(engine, best_params, subst_template=subst_template)
    return final, best_params, history


class _Adam:
    """optax.adam(learning_rate) with its defaults, over a dict of tensors
    (a flat vector is a dict of one): the moments, the bias corrections in
    float64 cast to each moment's dtype, and the update m / (sqrt(v) + eps)
    scaled by -learning_rate."""

    def __init__(self, params: Dict[str, torch.Tensor], learning_rate):
        self.lr = learning_rate
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params, grads):
        """params - learning_rate * adam(grads): descent on `grads`."""
        self.count += 1
        c1 = 1 - ADAM_B1 ** self.count
        c2 = 1 - ADAM_B2 ** self.count
        out = {}
        for k, g in grads.items():
            self.mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * self.mu[k]
            self.nu[k] = (1 - ADAM_B2) * (g * g) + ADAM_B2 * self.nu[k]
            update = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2)
                                          + ADAM_EPS)
            out[k] = params[k] + update * (-self.lr)
        return out


def _track_best(lks, entry, after, best, best_item, stale, tol):
    """JAX's best-parameter bookkeeping over one chunk: lks[i] is the logL
    AT the parameters that produced it (`entry` for i = 0, else
    `after[i - 1]`). Returns (best, best_item, stale)."""
    for i, lk in enumerate(lks):
        if lk > best + tol:
            best = float(lk)
            best_item = entry if i == 0 else after[i - 1]
            stale = 0
        else:
            stale += 1
    return best, best_item, stale


def adam_ascent(fn, params, steps: int = 200, learning_rate: float = 0.02,
                tol: float = 1e-6, patience: int = 25, chunk: int = 25):
    """Chunked Adam ascent on a differentiable scalar fn(params); returns
    (best logL, best params, per-step history). The engine-aware wrapper is
    maximize_loglikelihood."""
    params = {k: v.detach() for k, v in params.items()}
    opt = _Adam(params, learning_rate)
    chunk = max(1, min(chunk, steps, patience))

    def value_and_grad(q):
        q = {k: v.detach().requires_grad_(True) for k, v in q.items()}
        value = fn(q)
        grads = torch.autograd.grad(value, list(q.values()))
        return value.detach(), dict(zip(q, grads))

    history = []
    best = -np.inf
    best_params = params
    stale = 0
    done = 0
    while done < steps and stale < patience:
        entry = params
        n = min(chunk, steps - done)
        values, after = [], []
        for _ in range(n):
            value, g = value_and_grad(params)
            # descent on -fn: the gradient of the loss is -g
            params = opt.step(params, {k: -v for k, v in g.items()})
            values.append(value)
            after.append(params)
        lks = torch.stack(values).to(torch.float64).cpu().numpy()
        history.extend(lks.tolist())
        done += n
        best, best_params, stale = _track_best(lks, entry, after, best,
                                               best_params, stale, tol)

    # the final params were never evaluated inside the loop
    final_candidates = [best_params, params]
    with torch.no_grad():
        finals = [float(fn(q)) for q in final_candidates]
    best_params = final_candidates[int(np.argmax(finals))]
    return max(finals), best_params, history


def _ravel(params: Dict[str, torch.Tensor]):
    """(flat vector, unravel) in `jax.flatten_util.ravel_pytree`'s order:
    keys sorted, each row-major. unravel(X) takes [..., n] and gives each
    group with the same leading axes."""
    keys = sorted(params)
    shapes = [tuple(params[k].shape) for k in keys]
    sizes = [int(np.prod(s)) for s in shapes]
    x0 = torch.cat([params[k].reshape(-1) for k in keys])

    def unravel(x):
        out, off = {}, 0
        lead = x.shape[:-1]
        for k, shape, n in zip(keys, shapes, sizes):
            out[k] = x[..., off:off + n].reshape(lead + shape)
            off += n
        return out

    return x0, unravel


def make_fused_loglikelihood_fn(engine: TreeEngine,
                                optimize: Iterable[str] = ("subst",
                                                           "freqs"),
                                subst_template=None,
                                fd_chunk: int = 16):
    """Batched model-trial evaluator on the engine's OWN execution path.

    Returns (fn_batch, x0, unravel): `fn_batch(X)` maps a [K, n] matrix of
    flat unconstrained parameter vectors (the `ravel_pytree` order of the
    params, recoverable with `unravel(x)`) to [K] log-likelihoods. Every
    trial decomposes its model on the device (ops/eigen.update_eigen_torch,
    all K at once) and runs the path `execution_path` names
    (`TreeEngine._trial_loglikelihoods`): on 'fused' and
    'repeats-dense-fused' one launch of the candidate form a chunk of 128
    trials; on 'levels-kernel' one launch of the level kernel's trial form
    a level a chunk, on 'pool-pallas' one of the pool kernel's a traversal
    (4x4) or a level a chunk, on 'pool' its plain version a level a chunk.
    `fd_chunk` is JAX's vmap width, a TPU memory bound; it is kept in the
    signature and not used (neither is JAX's padding of K to a chunk
    multiple): fn_batch returns exactly K values.

    The kernels are not differentiable; this is the evaluation half of
    `maximize_fused`'s central-difference loop. Branch lengths are out of
    scope (newton_smooth_all owns them)."""
    del fd_chunk
    p = engine.partition
    optimize = tuple(optimize)
    if "branches" in optimize:
        raise C.PllError(
            C.ERROR_PARAM_INVALID,
            "fused FD optimization covers model groups ('subst', "
            "'freqs'); branch lengths use newton_smooth_all / "
            "TreeEngine.newton_loop")
    if not any(g in optimize for g in ("subst", "freqs")):
        raise C.PllError(C.ERROR_PARAM_INVALID,
                         "nothing to optimize: pass 'subst' and/or 'freqs'")
    subst_template = _check_template(p, subst_template)
    d = p.dtype
    expand_subst = _make_subst_expander(p, subst_template, d, engine.device)
    params0 = _build_params(engine, optimize, subst_template)
    if not params0:
        raise C.PllError(
            C.ERROR_PARAM_INVALID,
            "the requested groups leave no free parameter (every "
            "subst_template class is pinned and freqs are fixed)")
    x0, unravel = _ravel(params0)
    base_freqs = torch.tensor(p.frequencies, dtype=d, device=engine.device)

    def fn_batch(X: torch.Tensor) -> torch.Tensor:
        k = X.shape[0]
        params = unravel(X)
        freqs = (torch.softmax(params["freq_logits"], dim=-1)
                 if "freq_logits" in params
                 else base_freqs.expand(k, *base_freqs.shape))
        subst = expand_subst(params)
        subst = subst.expand(k, *subst.shape[-2:])
        m = freqs.shape[1]
        ev, evecs, ivecs = ops_eigen.update_eigen_torch(
            subst.reshape(k * m, -1), freqs.reshape(k * m, -1))
        eigen = (ev.view(k, m, -1), evecs.view(k, m, *evecs.shape[1:]),
                 ivecs.view(k, m, *ivecs.shape[1:]))
        return engine._trial_loglikelihoods(eigen, freqs)

    return fn_batch, x0, unravel


def maximize_fused(engine: TreeEngine,
                   optimize: Iterable[str] = ("subst", "freqs"),
                   steps: int = 150, learning_rate: float = 0.05,
                   tol: float = 1e-4, patience: int = 25,
                   chunk: int = 10, fd_step: float = 0.02,
                   fd_chunk: int = 16, subst_template=None):
    """Model-parameter (subst rates / frequencies) ascent that never leaves
    the engine's own execution path: a central-difference Adam whose 2n+1
    trial models a step (n free parameters) are ONE call of
    `make_fused_loglikelihood_fn`'s evaluator -- on 'fused' one launch of
    the candidate form for up to 128 trials. float32 evaluation noise bounds
    the precision (~1e-2 logL); a float64 pallas=False engine on the
    gradient route converges tighter. Returns (best logL, best params,
    history); the best params are applied back to the partition."""
    fnb, x0, unravel = make_fused_loglikelihood_fn(
        engine, optimize, subst_template=subst_template, fd_chunk=fd_chunk)
    n = int(x0.numel())
    eye = torch.eye(n, dtype=x0.dtype, device=x0.device) * fd_step
    opt = _Adam({"x": x0}, learning_rate)
    chunk = max(1, min(chunk, steps, patience))

    history = []
    best = -np.inf
    best_x = x0
    x = x0
    stale = 0
    done = 0
    while done < steps and stale < patience:
        entry = x
        k = min(chunk, steps - done)
        values, after = [], []
        for _ in range(k):
            f = fnb(torch.cat([x[None], x[None] + eye, x[None] - eye]))
            g = (f[1:n + 1] - f[n + 1:]) / (2.0 * fd_step)
            # f[0] is logL AT the pre-update x
            x = opt.step({"x": x}, {"x": -g})["x"]           # ascent
            values.append(f[0])
            after.append(x)
        lks = torch.stack(values).to(torch.float64).cpu().numpy()
        history.extend(lks.tolist())
        done += k
        best, best_x, stale = _track_best(lks, entry, after, best, best_x,
                                          stale, tol)

    # the loop's last x was never evaluated: score both candidates
    f_final = fnb(torch.stack([best_x, x])).to(torch.float64).cpu().numpy()
    if f_final[1] > f_final[0]:
        best_x, final = x, float(f_final[1])
    else:
        final = float(f_final[0])
    best_params = unravel(best_x)
    _apply(engine, best_params, subst_template=subst_template)
    return final, best_params, history


def _sweep_inputs(engine: TreeEngine, tree):
    """(arguments, keywords) of ops/branch_sweep.py:newton_sweep for the
    engine's partition and model and `tree`'s topology and lengths: the
    schedule, the postorder's level tables for the combined buffers (trash
    row K + n_aux, zero row K + n_aux + 1), the tree's lengths as the Newton
    start and, for the first refresh, the P-matrices of the engine's
    branches: what JAX's pmatrix buffer holds once an evaluation has filled
    it (libpll2_tpu/optimize.py:545-556). After `maximize_loglikelihood`
    of the branches, the engine's branches are the optimized ones while the
    tree keeps its old lengths until `apply_branches_to_tree`. Of a
    sharded partition the buffers are None: `newton_smooth_all` takes its
    shards'."""
    from .ops import branch_sweep
    from .ops import levels as ops_levels
    from .trees import create_operations, traverse

    p = engine.partition
    operations, branches, pmatrix_indices = create_operations(
        traverse(tree.vroot))
    p._check_operations(operations)
    steps, n_aux = branch_sweep.build_smoothing_schedule(
        tree, p.nodes, p.scale_buffers, p.prob_matrices)
    K = p.scale_buffers
    tables = ops_levels.tables_to_device(ops_levels.pack_pallas_levels(
        operations, p.tips, zero_scaler_row=K + n_aux + 1,
        trash_scaler_row=K + n_aux), p.device)
    blen = torch.as_tensor(engine._branch_vector(branches, pmatrix_indices),
                           dtype=p.dtype, device=p.device)
    (ev, inv_evecs, evecs, prop_invar, rates, rate_weights, freqs,
     params_idx_rates) = engine._model_args()
    pmatrix = ops_pmatrix.update_prob_matrices(
        ev, inv_evecs, evecs, prop_invar, rates, params_idx_rates,
        engine.branches)
    pw, invariant = engine._site_args()
    args = (p.clv, p.scale_buffer, pmatrix, blen, ev, inv_evecs, evecs,
            prop_invar, rates, rate_weights, freqs, params_idx_rates, tables,
            steps, pw, invariant, p.scale_threshold, p.scale_factor)
    return args, dict(n_aux=n_aux, asc_type=engine.asc_type,
                      n_real=engine.n_real)


def newton_smooth_all(engine: TreeEngine, tree, passes: int = 2,
                      iterations: int = 8) -> float:
    """All-branches Newton smoothing (libpll2_tpu/optimize.py:519): per
    pass a postorder refresh with the current lengths, then a pre-order
    walk that optimizes every edge with `iterations` Newton updates,
    reorienting CLVs through auxiliary "up" rows (ops/branch_sweep.py).
    Every CLV op runs on the level kernel (its plain version for CPU
    tensors and float64 ones: ops/levels.py:level_for). The tree's branch
    lengths, the engine's branches and the partition's dense buffers are
    updated; returns the final
    log-likelihood. On a sharded partition every CLV op and sumtable runs
    once a shard, and each Newton update takes the d1 and d2 summed over
    the shards (ops/branch_sweep.py:newton_sweep_shards)."""
    from .ops import branch_sweep

    p = engine.partition
    units = engine._units()
    if units[0].partition.clv is None:
        raise C.PllError(
            C.ERROR_PARAM_INVALID,
            "newton_smooth_all needs dense CLV buffers (directional "
            "'up' rows); pooled site-repeats partitions are not "
            "supported — use newton_optimize_branches or a dense "
            "partition")
    args, kw = _sweep_inputs(engine, tree)
    # each block brings its buffers and site data (args[:2], args[14:16])
    blocks = [(u.partition.clv, u.partition.scale_buffer, *u._site_args(),
               u.partition._modes().get("col0")) for u in units]
    new_branches, pmatrix, outs = branch_sweep.newton_sweep_shards(
        blocks, p.mesh, *args[2:14], *args[16:], passes=passes,
        iterations=iterations, **kw)
    for u, (clv, scaler) in zip(units, outs):
        up = u.partition
        up.clv.copy_(clv)
        up.scale_buffer.copy_(scaler)
        up.pmatrix.copy_(pmatrix.to(up.device))
    engine.branches = new_branches
    engine.apply_branches_to_tree(tree)
    return engine.loglikelihood()


def newton_optimize_branches(partition, tree, params_indices,
                             passes: int = 2, iterations: int = 8,
                             tol: float = 1e-6) -> float:
    """Classic per-edge Newton branch-length optimization through the
    step-by-step API -- the loop the reference's consumers build from
    pll_update_sumtable / pll_compute_likelihood_derivatives
    (examples/newton, RAxML-NG's smoothings). For each edge: a full
    traversal rooted at the edge, one sumtable, then a few Newton
    iterations on its length. Returns the final logL."""
    from .ops.derivatives import newton_step as _guarded
    from .trees import create_operations, traverse

    def edges():
        seen = set()
        for node in tree.nodes():
            halves = [node] if node.is_tip() else list(node.ring())
            for h in halves:
                if h.back is not None and id(h) not in seen \
                        and id(h.back) not in seen:
                    seen.add(id(h))
                    yield h if not h.is_tip() else h.back

    def scalar(v):
        return torch.tensor(v, dtype=torch.float64)

    logl = None
    for _ in range(passes):
        for h in edges():
            ops, branches, pmat_idx = create_operations(traverse(h))
            partition.update_prob_matrices(params_indices, pmat_idx,
                                           branches)
            partition.update_partials(ops)
            st = partition.update_sumtable(
                h.clv_index, h.back.clv_index,
                h.scaler_index, h.back.scaler_index, params_indices)
            blen = h.length
            for _ in range(iterations):
                d1, d2 = partition.compute_likelihood_derivatives(
                    st, params_indices, blen,
                    parent_scaler_index=h.scaler_index,
                    child_scaler_index=h.back.scaler_index)
                new = float(_guarded(scalar(blen), scalar(d1), scalar(d2),
                                     C.OPT_MIN_BRANCH_LEN,
                                     C.OPT_MAX_BRANCH_LEN))
                if abs(new - blen) < tol:
                    blen = new
                    break
                blen = new
            h.length = h.back.length = blen
            partition.update_prob_matrices(params_indices,
                                           [h.pmatrix_index], [blen])
            logl = partition.compute_edge_loglikelihood(
                h.clv_index, h.scaler_index, h.back.clv_index,
                h.back.scaler_index, h.pmatrix_index, params_indices)
    return logl


def _apply(engine: TreeEngine, params: Dict[str, torch.Tensor],
           subst_template=None) -> None:
    """Write optimized parameters back: branches to the engine, rates and
    frequencies to the partition's host mirrors (and its eigensystem)."""
    p = engine.partition
    if "log_branches" in params:
        engine.branches = torch.exp(params["log_branches"]).to(p.dtype)
    if "log_subst" in params:
        free = np.exp(params["log_subst"].detach().cpu().numpy()
                      .astype(np.float64))
        if subst_template is not None:
            full = np.concatenate(
                [np.ones((p.rate_matrices, 1)), free], axis=1)
            subst = full[:, np.asarray(subst_template, np.int32)]
        else:
            subst = np.concatenate(
                [free, np.ones((p.rate_matrices, 1))], axis=1)
        for m in range(p.rate_matrices):
            p.set_subst_params(m, subst[m])
    if "freq_logits" in params:
        logits = (params["freq_logits"].detach().cpu().numpy()
                  .astype(np.float64))
        f = np.exp(logits - logits.max(axis=1, keepdims=True))
        f = f / f.sum(axis=1, keepdims=True)
        for m in range(p.rate_matrices):
            p.set_frequencies(m, f[m])
    if "log_subst" in params or "freq_logits" in params:
        for m in range(p.rate_matrices):
            p.update_eigen(m)


def _brent_minimize(f, lo, hi, tol=1e-4, max_iter=60):
    """Scalar bounded minimization (Brent), carried over from
    libpll2_tpu/optimize.py:656."""
    gold = 0.3819660112501051
    a, b = lo, hi
    x = w = v = a + gold * (b - a)
    fx = fw = fv = f(x)
    d = e = 0.0
    for _ in range(max_iter):
        m = 0.5 * (a + b)
        tol1 = tol * abs(x) + 1e-10
        if abs(x - m) <= 2 * tol1 - 0.5 * (b - a):
            break
        use_golden = True
        if abs(e) > tol1:
            r = (x - w) * (fx - fv)
            q = (x - v) * (fx - fw)
            p = (x - v) * q - (x - w) * r
            q = 2 * (q - r)
            if q > 0:
                p = -p
            q = abs(q)
            if (abs(p) < abs(0.5 * q * e) and p > q * (a - x)
                    and p < q * (b - x)):
                e, d = d, p / q          # parabolic step
                u = x + d
                if u - a < 2 * tol1 or b - u < 2 * tol1:
                    d = tol1 if x < m else -tol1
                use_golden = False
        if use_golden:
            e = (b if x < m else a) - x
            d = gold * e
        u = x + (d if abs(d) >= tol1 else (tol1 if d > 0 else -tol1))
        fu = f(u)
        if fu <= fx:
            if u < x:
                b = x
            else:
                a = x
            v, w, x = w, x, u
            fv, fw, fx = fw, fx, fu
        else:
            if u < x:
                a = u
            else:
                b = u
            if fu <= fw or w == x:
                v, w = w, u
                fv, fw = fw, fu
            elif fu <= fv or v == x or v == w:
                v, fv = u, fu
    return x, fx


def optimize_gamma_shape(engine: TreeEngine, lo: float = 0.02,
                         hi: float = 100.0, tol: float = 1e-4,
                         mode: int = C.GAMMA_RATES_MEAN):
    """Brent optimization of the Gamma shape alpha over log(alpha): each
    trial is one `loglikelihood()` at re-discretized category rates (the
    discretization is host code). Applies the best alpha's rates to the
    partition; returns (best alpha, logL)."""
    from .ops.gamma import compute_gamma_cats as _cats
    p = engine.partition
    R = p.rate_cats
    if R < 2:
        raise C.PllError(C.ERROR_PARAM_INVALID,
                         "gamma shape needs >= 2 rate categories")

    def neg(alpha):
        p.set_category_rates(_cats(float(alpha), R, mode))
        return -engine.loglikelihood()

    x, fx = _brent_minimize(lambda t: neg(np.exp(t)),
                            np.log(lo), np.log(hi), tol=tol)
    alpha = float(np.exp(x))
    p.set_category_rates(_cats(alpha, R, mode))
    return alpha, -fx


def optimize_pinv(engine: TreeEngine, lo: float = 1e-6, hi: float = 0.99,
                  tol: float = 1e-5, params_index: int = 0):
    """Brent optimization of the invariant-sites proportion (+I): each trial
    is one `loglikelihood()`. Applies the best p-inv; returns (best p-inv,
    logL)."""
    p = engine.partition

    def neg(pinv):
        p.update_invariant_sites_proportion(params_index, float(pinv))
        return -engine.loglikelihood()

    x, fx = _brent_minimize(neg, lo, hi, tol=tol)
    p.update_invariant_sites_proportion(params_index, float(x))
    return float(x), -fx
