"""Parity-grade multiword Green's-function rebuild at the engine level.

Computes G(0,0) = [I + B(beta,0)]^{-1} for a FIXED field configuration
with multiword numerics built entirely from f32 (and int8) operations
(ops/df_linalg with nm=df32 or nm=tf32) — the north-star parity
quantity (BASELINE.md: max|dG| < 1e-10 vs the reference on a fixed
field configuration).

Tiers (fixed-field chain error vs 100-digit mpmath gold, beta=8, n=64,
nt=80 — tests/test_tf_linalg.py pins the same at CPU-test size):

    nm=df32   ~1e-8     sampling-grade parity (2 orders below the
                        reference's own 1e-6 stabilization warning)
    nm=tf32   ~1e-11    BELOW the f64 stabilized chain's own 6.7e-10 —
                        the measurement-grade tier that closes the
                        <1e-10 north star

Pass the f64-BUILT twin of the running model (so expK carries its full
scipy-computed precision)::

    m64 = AttractiveHubbard.build(lat, U=U, t=t, mu=mu, beta=beta,
                                  nt=nt, dtype=jnp.float64)
    G_tf, log_det = parity_rebuild_greens(m64, cfg, state.fields,
                                          nm=tf32)
    err = jnp.max(jnp.abs(G_tf.hi - state.G[0]))   # f32-chain deviation
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from dqmc_tpu import hsfield, platform
from dqmc_tpu.engine.state import EngineConfig
from dqmc_tpu.ops import df32, df_linalg


def _maybe_jit(f):
    """jit where platform.jit_multiword() allows it; eager otherwise.

    XLA:CPU's backend codegen at optimization level > 0 corrupts fused
    multiword graphs: the identical fold chain measures 1.1e-8 eager
    vs 5.4e-4 jitted on CPU (LLVM-level contraction/reassociation across
    the fused error-free transformations; --xla_backend_optimization_level=0
    restores 1.3e-8) — see NOTES.md.
    """
    jitted = jax.jit(f)

    def call(*args, **kw):
        if not platform.jit_multiword():
            return f(*args, **kw)
        return jitted(*args, **kw)

    return call


def _expv_table_f64(model, sign: float = 1.0) -> np.ndarray:
    """exp(sign * g * eta(s)) for the 4 field states, f64 (4,).

    sign selects the flavor coupling: +1 for the attractive model's
    single stored flavor (both spins identical, model.cpp:62-72) and
    for the repulsive model's up flavor; -1 for repulsive down
    (models/repulsive_hubbard.expV_diag)."""
    eta = np.asarray(hsfield.ETA, np.float64)
    if isinstance(model.g, jax.core.Tracer):
        # replica-stacked PT tier: the model rides a vmap axis (one beta
        # per slot), so g is traced — build the table in-graph at f64.
        # exp on emulated f64 is ~1-ulp; the tier target is 2^-33-grade
        # relative, so the in-graph table is grade-neutral.
        return jnp.exp(sign * jnp.asarray(model.g, jnp.float64)
                       * jnp.asarray(eta))
    g = float(np.asarray(model.g, np.float64))
    return np.exp(sign * g * eta)


def _flavor_signs(model):
    """Per-stored-flavor coupling signs (see _expv_table_f64)."""
    if model.n_flavor == 1:
        return (1.0,)
    return (1.0, -1.0)


def _slice_B(model, expK, fields_l: jax.Array, nm, sign: float = 1.0):
    """Multiword B_l = diag(expV(s_l)) @ expK (model.cpp:75-80 semantics).

    The diagonal scaling must be a FULL multiword multiply (a plain
    ``hi*hi`` product drops its own rounding error, which caps every B
    at 2^-24 relative and with it the whole parity tier).  Select-chain
    over the 4 field values, not a gather (NOTES.md: tiny jnp table
    gathers lower to element-at-a-time XLA gathers)."""
    tbl = nm.from_f64(jnp.asarray(_expv_table_f64(model, sign)))   # (4,)

    def sel(comp):
        out = jnp.zeros(fields_l.shape, jnp.float32)
        for v in range(4):
            out = jnp.where(fields_l == v, comp[v], out)
        return out

    ev = nm.cmap(sel, tbl)
    ev = nm.cmap(lambda c: c[..., :, None], ev)
    return nm.mul(expK, ev)


def _check_model(model):
    if model.n_flavor not in (1, 2):
        raise NotImplementedError(
            "parity rebuild: 1- or 2-flavor models only")
    if model.expK.dtype != jnp.float64:
        raise ValueError("parity rebuild needs the f64-built model twin "
                         "(expK at full precision); build with "
                         "dtype=jnp.float64")


def rebuild_chain(model, cfg: EngineConfig, fields: jax.Array, nm=df32,
                  *, _wrap=lambda f: f, use_scan: bool | None = None,
                  flavor_sign: float = 1.0):
    """Pure multiword chain rebuild: fields (nt, ns) -> (G, log_det).

    jit/vmap-safe (fixed trip counts, no data-dependent control flow);
    callers jit/vmap the whole thing.  ``_wrap`` optionally wraps each
    stage (parity_rebuild_greens passes per-piece jit for the
    interactive probe path).

    ``use_scan`` (auto when None: on iff nt % n_stab == 0 and _wrap is
    identity): the fold loop runs as ONE ``lax.scan`` body instead of an
    unrolled chain — each multiword matmul lowers to 28-55 int8
    dots, so an unrolled 32-fold chain is a 100k-op HLO that XLA chews
    on for minutes, while the scan compiles a single fold.  Seeded with
    an identity LDR (the Ozaki matmul is exact on identity operands, so
    fold #1 through mat_mul_ldr is numerically identical to a bare
    to_ldr — verified by tests/test_parity.py's gold pin, which runs
    the scan path).
    """
    ns = model.n_sites
    expK = nm.from_f64(model.expK)
    if use_scan is None:
        use_scan = cfg.nt % cfg.n_stab == 0

    def block_product(fields_blk):
        Bbar = nm.df(jnp.eye(ns, dtype=jnp.float32))
        n_blk = fields_blk.shape[0]
        for i in range(n_blk):
            B = _slice_B(model, expK, fields_blk[i], nm, flavor_sign)
            Bbar = nm.matmul(B, Bbar)
        return Bbar

    inv = _wrap(
        lambda F1, F2t: df_linalg.inv_one_plus_ldr_dag(F1, F2t, nm=nm))
    eye = nm.df(jnp.eye(ns, dtype=jnp.float32))

    if use_scan:
        # dag (transpose-suffix) order: latest block first
        blocks = fields[:cfg.n_stack * cfg.n_stab].reshape(
            cfg.n_stack, cfg.n_stab, -1)[::-1]
        F0 = df_linalg.LDRdf(eye, nm.df(jnp.ones(ns, jnp.float32)),
                             nm.df(jnp.eye(ns, dtype=jnp.float32)),
                             jnp.zeros((ns,), jnp.int32))

        def body(F, fields_blk):
            BbarT = df_linalg.transpose(block_product(fields_blk))
            return df_linalg.mat_mul_ldr(BbarT, F, nm=nm), None

        F2t, _ = jax.lax.scan(body, F0, blocks)
    else:
        bp = _wrap(block_product)
        fold = _wrap(
            lambda BbarT, F: df_linalg.mat_mul_ldr(BbarT, F, nm=nm))
        first = _wrap(lambda M: df_linalg.to_ldr(M, nm=nm))
        F2t = None
        for i_stack in range(cfg.n_stack - 1, -1, -1):
            l0 = i_stack * cfg.n_stab
            l1 = min(l0 + cfg.n_stab, cfg.nt)
            Bbar = bp(fields[l0:l1])
            BbarT = df_linalg.transpose(Bbar)
            F2t = first(BbarT) if F2t is None else fold(BbarT, F2t)

    F1 = df_linalg.to_ldr(eye, nm=nm) if use_scan else _wrap(
        lambda M: df_linalg.to_ldr(M, nm=nm))(eye)
    return inv(F1, F2t)


def parity_rebuild_greens(model, cfg: EngineConfig, fields: jax.Array,
                          nm=df32):
    """(G as an nm tuple (ns, ns), log_det) for one walker's fields.

    Single flavor (the attractive model); the chain runs the dag
    (transpose-suffix) fold exactly like engine.sweep's rebuild
    (dqmc.cpp:43-72), block products dense multiword, one multiword QR
    per block.  nm=df32 for the sampling tier, nm=tf32 for the
    <1e-10 measurement tier.
    """
    _check_model(model)
    # per-piece jit + unrolled loop: on CPU each piece runs eagerly
    # (the XLA:CPU hazard), on accelerators each piece compiles once
    return rebuild_chain(model, cfg, fields, nm, _wrap=_maybe_jit,
                         use_scan=False)


def _identity_ldr(ns: int, nm, nfl: int | None = None):
    shape = (ns, ns) if nfl is None else (nfl, ns, ns)
    eye = nm.df(jnp.broadcast_to(jnp.eye(ns, dtype=jnp.float32), shape))
    ones = nm.df(jnp.ones(shape[:-2] + (ns,), jnp.float32))
    return df_linalg.LDRdf(eye, ones, eye,
                           jnp.zeros(shape[:-2] + (ns,), jnp.int32))


def _slice_invB(model, invexpK, fields_l: jax.Array, nm,
                sign: float = 1.0):
    """Multiword B_l^{-1} = invexpK @ diag(1/expV(s_l)) (column scaling)."""
    tbl = nm.from_f64(jnp.asarray(1.0 / _expv_table_f64(model, sign)))

    def sel(comp):
        out = jnp.zeros(fields_l.shape, jnp.float32)
        for v in range(4):
            out = jnp.where(fields_l == v, comp[v], out)
        return out

    ev = nm.cmap(sel, tbl)
    ev = nm.cmap(lambda c: c[..., None, :], ev)
    return nm.mul(invexpK, ev)


def _scan(f, carry, xs, use_scan: bool):
    """lax.scan, or an eager Python loop over the leading axis.

    The loop form exists for CPU: XLA:CPU's backend codegen corrupts
    fused multiword graphs inside compiled scan bodies (module docstring
    of ops/df_linalg.py; measured again here — the jitted uneq scan
    degrades the df tier from ~1e-8 to 2.3e-5 on CPU).  Eager per-primitive execution restores
    the tier at Python-loop speed, which tests accept."""
    if use_scan:
        return jax.lax.scan(f, carry, xs)
    length = jax.tree_util.tree_leaves(xs)[0].shape[0]
    ys = []
    for i in range(length):
        x = jax.tree_util.tree_map(lambda a: a[i], xs)
        carry, y = f(carry, x)
        ys.append(y)
    stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *ys)
    return carry, stacked


# boundaries per chunk in the block-batched triplet factorization (see
# one_batched): 4 x W x nfl simultaneous 256^2 systems keep the device busy
# while the per-chunk working set stays ~n_stack/4 below the full batch.
# Env-overridable (read at import): the stretch scale (ns=1024) needs
# chunk 1-2 — one boundary's factorization intermediates are already
# ~64x the headline's per-boundary footprint.
import os as _os
_TRIPLET_CHUNK = int(_os.environ.get("DQMC_TRIPLET_CHUNK", "4"))
# blocks per group in the batched propagation/emit phase (same memory
# argument: full-batch carries at the tf32 headline are ~GBs each;
# 8 x W x nfl matmuls per step still keep the device busy)
_BLOCK_GROUP = int(_os.environ.get("DQMC_BLOCK_GROUP", "8"))


def _divisor_stride(nt: int, want: int) -> int:
    """Largest stabilization stride <= want that divides nt (the
    block-structured scans need exact blocking)."""
    s = max(1, min(want, nt))
    while nt % s:
        s -= 1
    return s


def measurement_uneq_fn(model64, cfg: EngineConfig, nm, measure_fn, *,
                        symmetric: bool = False,
                        n_stab: int | None = None,
                        use_scan: bool | None = None,
                        prop_nm=None, emit_greens: bool = False):
    """Batched measurement-grade unequal-time sweep.

    Returns ``uneq_step(states) -> (ys, err)`` for
    measure.manager.make_measured_iter: the full tau-resolved triplet
    (Gtt, Gt0, G0t)(tau) is rebuilt from the walker's FIELDS at nm
    precision — the measurement-tier twin of engine.uneqtime
    .sweep_unequal_time (dqmc.cpp:458-514), so greenTau / doublonTau /
    currxxTau (model.cpp:290-392, the superfluid-stiffness input) reach
    the same grade as the equal-time tier (<1e-10 at nm=tf32) instead
    of the sampling engine's f32.

    Structure mirrors the reference's measurement sweep exactly:
    a multiword suffix stack B(beta, k*n_stab)^T built once per call,
    then a forward block scan that propagates the triplet slice by
    slice (5 multiword matmuls per slice), restabilizes at block ends
    through the shared-factorization inv_triplet_dag, and emits
    ``measure_fn(Gtt, Gt0, G0t, G00)`` per tau on the f64 views.
    ``err`` is the propagated-vs-stabilized self-check at the tier's
    own grade (the check_error analogue, dqmc.cpp:500-511).

    ``emit_greens=True``: return ``(ys, err, G)`` where G is the
    measurement-basis equal-time Green's function (W, nfl, ns, ns) f64
    — the tier's G00, already half-warped.  This replaces a separate
    measurement_greens_fn in the fused measured iteration: the suffix
    chain is ALREADY folded here, so the equal-time tier's whole
    second fold chain (~n_stack sequential multiword QRs per walker)
    disappears from the measured sweep.

    ``prop_nm`` — the arithmetic of the WITHIN-BLOCK propagation (the 5
    multiword matmuls per slice); default nm itself.  A df32-propagation
    "mixed" mode under nm=tf32 was measured a dead end: the sweep is
    dominated by the sequential multiword QR folds, not the slice wraps,
    while the mid-block df drift reached 7.2e-10 at the 16x16 headline,
    eating the <1e-10 target.  The shipped fold-count levers
    are the round-4 stride defaults below plus the block-batched
    triplet/propagation formulation (one_batched).
    """
    _check_model(model64)
    if use_scan is None:
        # default: compiled scan (the production driver jits the whole
        # measured iteration, where an unrolled multiword chain would be
        # a 100k-op HLO).  Tests that need the tier's true grade on CPU
        # pass use_scan=False and call eagerly (see _scan).
        use_scan = True
    ns = model64.n_sites
    nt = cfg.nt
    if n_stab is None or n_stab <= 0:
        # Unlike the equal-time fold (which re-equilibrates at every QR),
        # the within-block wraps here propagate NAIVELY, so the tier
        # floor is amplified by cond(B_block)^2 ~ e^{4 dtau W stride}.
        # Measured at dtau = 0.2 (tests/test_parity.py chain): df32 reads
        # 2.5e-5 at stride*dtau = 1.0, 2.3e-9 at 0.4, 4.6e-11 at 0.2;
        # tf32 keeps <1e-10 at 1.0 (its 2^-68 floor has 1e5 headroom).
        # df32's default stride is therefore capped at 0.4/dtau so the
        # advertised ~1e-8 grade survives the propagation; tf32 keeps the
        # engine's schedule (the reference's own, dqmc.cpp:481-512).
        n_stab = cfg.n_stab
        if nm is df32:
            # 0.4/dtau cap: stride*dtau = 0.25 at the 16x16 headline
            # self-checked 6.9e-9 steady-state on thermalized fields
            # (better than stride 4's 4.7e-8, inside the ~1e-8 tier
            # grade).  On near-random INIT fields the f32-seeded
            # refinement can diverge by orders at ANY stride (see
            # measured_throughput's docstring in bench.py).  The tier's grade
            # contract applies to equilibrated configurations, which is
            # when measurements run (reference: main.cpp:147-156).
            dtau = float(model64.beta) / nt
            n_stab = max(1, min(n_stab, int(0.4 / dtau)))
        else:
            # tf32: the ENGINE stride.  A 2x default measured unhealthy
            # at the 16x16 headline (7.8e-6 steady-state with the
            # safeguarded IR) when the f32 seed came from a CGS2 QR,
            # while the Householder-seeded path passes <1e-10 at the
            # same stride*dtau (test_tf_uneq_2x_stride_fine_dtau_vs_
            # gold).  Whether the Householder seed now used everywhere
            # allows 2x at the headline is not measured; until then the
            # uneq tier keeps the engine schedule (the reference's own,
            # dqmc.cpp:481-512).
            n_stab = cfg.n_stab
    n_stab = _divisor_stride(nt, n_stab)
    n_stack = nt // n_stab
    if prop_nm is None:
        prop_nm = nm
    pn = prop_nm
    if pn is not nm:
        from dqmc_tpu.ops import tf32 as _tf32
        if not (nm is _tf32 and pn is df32):
            raise ValueError("measurement_uneq_fn: prop_nm must be nm "
                             "itself, or df32 under nm=tf32")
        conv = _tf32.to_df
    else:
        conv = lambda x: x  # noqa: E731
    signs = _flavor_signs(model64)
    nfl = len(signs)
    expK = nm.from_f64(model64.expK)
    expK_p = pn.from_f64(model64.expK)
    invexpK_p = pn.from_f64(model64.invexpK)
    eyeB32 = jnp.broadcast_to(jnp.eye(ns, dtype=jnp.float32),
                              (nfl, ns, ns))

    def bcast(mod, M):
        return mod.cmap(lambda c: jnp.broadcast_to(c, (nfl, ns, ns)), M)

    left = bcast(nm, nm.from_f64(model64.invexpK_half))
    right = bcast(nm, nm.from_f64(model64.expK_half))
    left_p = bcast(pn, pn.from_f64(model64.invexpK_half))
    right_p = bcast(pn, pn.from_f64(model64.expK_half))

    def warp_m(G):
        # engine.sweep.half_warp convention: G~ = invexpK_half @ G @ expK_half
        return nm.matmul(nm.matmul(left, G), right) if symmetric else G

    def warp_p(G):
        return pn.matmul(pn.matmul(left_p, G), right_p) if symmetric else G

    def B_all(fields_l):
        """(nfl, ns, ns) multiword B_l at nm, one stored flavor per sign."""
        Bs = [_slice_B(model64, expK, fields_l, nm, s) for s in signs]
        return nm.cmap(lambda *cs: jnp.stack(cs), *Bs)

    def B_all_p(fields_l):
        Bs = [_slice_B(model64, expK_p, fields_l, pn, s) for s in signs]
        return pn.cmap(lambda *cs: jnp.stack(cs), *Bs)

    def invB_all_p(fields_l):
        Bs = [_slice_invB(model64, invexpK_p, fields_l, pn, s)
              for s in signs]
        return pn.cmap(lambda *cs: jnp.stack(cs), *Bs)

    def _suffix_stack(blocks):
        """Suffix LDR factors at block boundaries.  The suffix at
        boundary k holds B(beta, k*n_stab)^T; boundary n_stack is the
        identity (the identity padding that kills the reference's
        tau = beta special case, dqmc.cpp:265-274).  Each block's
        nm-grade product is emitted alongside and REUSED by the Bt0
        prefix fold (recomputed there before — ~n_stab nm matmuls per
        block saved).

        The scan emits its PRE-fold carry: at the iteration processing
        block k that carry IS the suffix at boundary k+1, so the
        boundary array ``bounds[k] = suffix[k+1]`` (k = 0..n_stack-1,
        identity last) comes straight out of the scan and the final
        carry is suffix[0] — no separate suffix stack and no
        shift-concat copy (each is a full n_stack-of-LDR buffer,
        ~1 GB at the 16x16 headline batch).

        Returns (F2t_0 = suffix[0], bounds, Bbars)."""
        def block_product(fields_blk):
            Bbar = nm.df(eyeB32)
            for i in range(n_stab):
                Bbar = nm.matmul(B_all(fields_blk[i]), Bbar)
            return Bbar

        def suf_body(F, fields_blk):
            Bbar = block_product(fields_blk)
            F2 = df_linalg.mat_mul_ldr(df_linalg.transpose(Bbar), F,
                                       nm=nm)
            return F2, (F, Bbar)

        F_id = _identity_ldr(ns, nm, nfl)
        F2t_0, (bounds_rev, Bbars_rev) = _scan(suf_body, F_id,
                                               blocks[::-1], use_scan)
        bounds = jax.tree_util.tree_map(lambda a: a[::-1], bounds_rev)
        Bbars = jax.tree_util.tree_map(lambda a: a[::-1], Bbars_rev)
        return F2t_0, bounds, Bbars

    def one(fields):
        """Sequential formulation (round-3): one lax.scan over blocks
        interleaving propagation, prefix folds, and per-block triplet
        stabilizations.  Kept as the DQMC_UNEQ_BATCHED=0 fallback and
        the eager/CPU truth path."""
        blocks = fields[:nt].reshape(n_stack, n_stab, -1)
        F2t_0, bounds, Bbars = _suffix_stack(blocks)

        G00, _ = df_linalg.inv_one_plus_ldr_dag(
            df_linalg.to_ldr(nm.df(eyeB32), nm=nm), F2t_0, nm=nm)
        # G00 feeds every tau's disconnected terms — warp it once at
        # full nm grade; the per-tau emits run at pn grade
        G00_64 = nm.to_f64(warp_m(G00))

        def emit64(Gtt, Gt0, G0t):
            return measure_fn(pn.to_f64(warp_p(Gtt)),
                              pn.to_f64(warp_p(Gt0)),
                              pn.to_f64(warp_p(G0t)), G00_64)

        def blk_body(carry, xs):
            Gtt, Gt0, G0t, Bt0, emax = carry            # pn tuples
            fields_blk, F2t_next, Bbar_blk = xs
            outs = []
            for k in range(n_stab):
                B = B_all_p(fields_blk[k])
                invB = invB_all_p(fields_blk[k])
                Gtt = pn.matmul(pn.matmul(B, Gtt), invB)
                Gt0 = pn.matmul(B, Gt0)
                G0t = pn.matmul(G0t, invB)
                if k == n_stab - 1:
                    Bt0 = df_linalg.mat_mul_ldr(Bbar_blk, Bt0, nm=nm)
                    Gtt_s, Gt0_s, G0t_s, _ = df_linalg.inv_triplet_dag(
                        Bt0, F2t_next, nm=nm)
                    err = jnp.zeros((), jnp.float64)
                    for a, b in ((Gtt, Gtt_s), (Gt0, Gt0_s), (G0t, G0t_s)):
                        err = jnp.maximum(err, jnp.max(jnp.abs(
                            pn.to_f64(a) - nm.to_f64(b))))
                    emax = jnp.maximum(emax, err)
                    Gtt, Gt0, G0t = conv(Gtt_s), conv(Gt0_s), conv(G0t_s)
                outs.append((Gtt, Gt0, G0t))
            stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *outs)
            ys = jax.vmap(emit64)(*stacked)
            return (Gtt, Gt0, G0t, Bt0, emax), ys

        G00_p = conv(G00)
        carry0 = (G00_p, G00_p, pn.sub(G00_p, pn.df(eyeB32)),
                  _identity_ldr(ns, nm, nfl), jnp.zeros((), jnp.float64))
        (Gtt, Gt0, G0t, Bt0, emax), ys = _scan(
            blk_body, carry0, (blocks, bounds, Bbars), use_scan)
        ys = jax.tree_util.tree_map(
            lambda a: a.reshape((nt,) + a.shape[2:]), ys)
        y0 = emit64(G00_p, G00_p, pn.sub(G00_p, pn.df(eyeB32)))
        ys = jax.tree_util.tree_map(
            lambda f, r: jnp.concatenate([f[None], r], axis=0), y0, ys)
        if emit_greens:
            return ys, emax, G00_64
        return ys, emax

    def one_batched(fields):
        """Block-batched formulation (round-4).

        Identical per-element arithmetic to ``one`` — the sequential
        critical path shrinks from

            n_stack QR folds (suffix) + nt slice propagations
            + n_stack prefix folds + n_stack triplet factorizations

        to the two fold scans (unchanged), ONE inv_triplet_dag batched
        over all n_stack boundaries (CGS2/refinement batch W*n_stack*
        nfl — throughput-bound instead of latency-bound),
        and n_stab batched propagation steps (each step advances every
        block's triplet at once).  The emitted ys and the self-check
        follow the exact sequential semantics: tau = k*n_stab + i emits
        the naively-propagated triplet for 0 < i < n_stab, the
        STABILIZED boundary triplet at block ends, and err is the
        propagated-vs-stabilized max over all blocks (dqmc.cpp:500-511
        analogue)."""
        blocks = fields[:nt].reshape(n_stack, n_stab, -1)
        F2t_0, bounds, Bbars = _suffix_stack(blocks)
        # NOTE a "suffix+prefix as one batch-2 fold scan, block products
        # batched out" variant was measured and reverted: CPU-bit-
        # identical, but compiled for the accelerator it moved the tf32
        # tier's self-check 6.8e-13 -> 1.4e-11 and broke the df32 tier's
        # gate outright (6.6e-7 -> 5.0e-4).

        G00, _ = df_linalg.inv_one_plus_ldr_dag(
            df_linalg.to_ldr(nm.df(eyeB32), nm=nm), F2t_0, nm=nm)
        G00_64 = nm.to_f64(warp_m(G00))

        def emit64(Gtt, Gt0, G0t):
            return measure_fn(pn.to_f64(warp_p(Gtt)),
                              pn.to_f64(warp_p(Gt0)),
                              pn.to_f64(warp_p(G0t)), G00_64)

        # prefix LDR stack: F1[b] = LDR of B(b*n_stab, 0), b = 1..n_stack
        def pre_body(F1, Bbar_blk):
            F1 = df_linalg.mat_mul_ldr(Bbar_blk, F1, nm=nm)
            return F1, F1

        _, prefixes = _scan(pre_body, _identity_ldr(ns, nm, nfl), Bbars,
                            use_scan)

        # Batched triplet factorization over boundaries 1..n_stack
        # (leading dim n_stack; every df_linalg op is batch-generic).
        # Fully batched, the factorization intermediates (M, the 2n-wide
        # refined RHS, Q/R) at leading n_stack take ~17.5 GB at the
        # headline (W=16 x n_stack=32 df32) — lax.map over chunks of
        # _TRIPLET_CHUNK boundaries keeps the batch large (W*chunk*nfl
        # systems) at 1/n_chunks the working set.  Eager/CPU path keeps the single full batch.
        chunk = next(c for c in (_TRIPLET_CHUNK, 2, 1) if n_stack % c == 0)
        if use_scan and chunk < n_stack:
            def _trip(xs):
                F1c, F2c = xs
                return df_linalg.inv_triplet_dag(F1c, F2c, nm=nm)[:3]
            reshape = lambda a: a.reshape(                  # noqa: E731
                (n_stack // chunk, chunk) + a.shape[1:])
            pre_c = jax.tree_util.tree_map(reshape, prefixes)
            bnd_c = jax.tree_util.tree_map(reshape, bounds)
            Gtt_s, Gt0_s, G0t_s = jax.lax.map(_trip, (pre_c, bnd_c))
            unshape = lambda a: a.reshape(                  # noqa: E731
                (n_stack,) + a.shape[2:])
            Gtt_s, Gt0_s, G0t_s = jax.tree_util.tree_map(
                unshape, (Gtt_s, Gt0_s, G0t_s))
        else:
            Gtt_s, Gt0_s, G0t_s, _ = df_linalg.inv_triplet_dag(
                prefixes, bounds, nm=nm)
        stab = (conv(Gtt_s), conv(Gt0_s), conv(G0t_s))

        # propagation anchors: block k starts from the stabilized
        # triplet at boundary k (k=0: G00; k>=1: batched triplet k)
        G00_p = conv(G00)
        t0 = (G00_p, G00_p, pn.sub(G00_p, pn.df(eyeB32)))
        anchors = jax.tree_util.tree_map(
            lambda a0, rest: jnp.concatenate([a0[None], rest[:-1]]),
            t0, stab)

        # B_all_p stacks flavors LEADING ((nfl, blk, ns, ns)); the
        # block-batched carry is (blk, nfl, ns, ns) — swap once
        swap = lambda M: pn.cmap(                          # noqa: E731
            lambda c: jnp.swapaxes(c, 0, 1), M)

        def prop_group(xs):
            """n_stab propagation steps + emits for a GROUP of blocks
            (batched over the group).  Grouping (lax.map below) bounds
            the working set like the triplet chunking above — full-batch
            propagation carries at tf32 headline scale are ~GBs each."""
            anc, f_blk, stab_g = xs           # (G, nfl, ns, ns) tuples
            Gtt, Gt0, G0t = anc
            fields_t = jnp.swapaxes(f_blk, 0, 1)     # (n_stab, G, ns)
            outs = []
            for i in range(n_stab):
                B = swap(B_all_p(fields_t[i]))
                invB = swap(invB_all_p(fields_t[i]))
                Gtt = pn.matmul(pn.matmul(B, Gtt), invB)
                Gt0 = pn.matmul(B, Gt0)
                G0t = pn.matmul(G0t, invB)
                if i < n_stab - 1:
                    outs.append(jax.vmap(emit64)(Gtt, Gt0, G0t))
            errg = jnp.zeros((), jnp.float64)
            for a, b in ((Gtt, stab_g[0]), (Gt0, stab_g[1]),
                         (G0t, stab_g[2])):
                errg = jnp.maximum(errg, jnp.max(jnp.abs(
                    pn.to_f64(a) - conv_to_f64(b))))
            ys_g = jax.tree_util.tree_map(
                lambda *a: jnp.stack(a, axis=1), *outs) if outs else None
            return ys_g, errg

        conv_to_f64 = pn.to_f64
        group = next(g for g in (_BLOCK_GROUP, 4, 2, 1)
                     if n_stack % g == 0)
        xs = (anchors, blocks, stab)
        if use_scan and group < n_stack:
            reshape = lambda a: a.reshape(                  # noqa: E731
                (n_stack // group, group) + a.shape[1:])
            xs = jax.tree_util.tree_map(reshape, xs)
            ys_prop, errs = jax.lax.map(prop_group, xs)
            ys_prop = jax.tree_util.tree_map(
                lambda a: a.reshape((n_stack,) + a.shape[2:]), ys_prop)
            err = jnp.max(errs)
        else:
            ys_prop, err = prop_group(xs)

        # assemble ys in tau order: tau 0, then per block k the
        # propagated i=1..n_stab-1 and the stabilized boundary k+1
        y0 = emit64(*t0)
        ys_stab = jax.vmap(emit64)(*stab)
        if ys_prop is not None:          # n_stab == 1 has no prop emits
            per_block = jax.tree_util.tree_map(
                lambda p, s: jnp.concatenate([p, s[:, None]], axis=1),
                ys_prop, ys_stab)
        else:
            per_block = jax.tree_util.tree_map(
                lambda s: s[:, None], ys_stab)
        ys = jax.tree_util.tree_map(
            lambda a: a.reshape((nt,) + a.shape[2:]), per_block)
        ys = jax.tree_util.tree_map(
            lambda f, r: jnp.concatenate([f[None], r], axis=0), y0, ys)
        if emit_greens:
            return ys, err, G00_64
        return ys, err

    import os
    batched = os.environ.get("DQMC_UNEQ_BATCHED", "1") not in (
        "0", "off", "false")
    impl = one_batched if batched else one

    if use_scan:
        return lambda states: jax.vmap(impl)(states.fields)

    def eager_batched(states):
        outs = [impl(states.fields[w])
                for w in range(states.fields.shape[0])]
        return jax.tree_util.tree_map(lambda *a: jnp.stack(a), *outs)

    return eager_batched


def measurement_greens_fn(model64, cfg: EngineConfig, nm, *,
                          symmetric: bool = False,
                          n_stab: int | None = None):
    """Batched measurement-grade Green's-function rebuild.

    Returns ``greens_fn(states) -> G (W, 1, ns, ns) f64`` for
    measure.manager.make_measured_iter: the equal-time G handed to the
    observables is rebuilt from the walker's field configuration at nm
    precision (nm=tf32: <1e-10 vs exact — BELOW the f64 grade the
    reference itself measures at), independent of the sampling engine's
    working precision.  ``symmetric`` applies the half-warp
    G~ = e^{+dtau K/2} G e^{-dtau K/2} (dqmc.cpp:288-315) in multiword,
    so the Trotter basis change does not truncate the tier.

    ``n_stab`` is the REBUILD's fold stride, independent of the sampling
    engine's: tf32's precision headroom tolerates a wider stride (fewer
    multiword QRs — they dominate the rebuild's cost).  Default for tf32
    is 2x the engine stride: at beta=8 that measures 3.7e-11 vs gold
    (vs 8.5e-12 at 1x — still 2.7x under the 1e-10 target); 4x blows
    the fold-input condition past the tier (1.6e-8 measured).  df32
    keeps the engine stride (its tier has no headroom).
    """
    _check_model(model64)
    if n_stab is None:
        from dqmc_tpu.ops import tf32 as _tf32
        n_stab = 2 * cfg.n_stab if nm is _tf32 else cfg.n_stab
    if cfg.nt % n_stab != 0:
        n_stab = cfg.n_stab                      # keep exact blocking
    import dataclasses as _dc
    cfg = _dc.replace(cfg, n_stab=n_stab)
    # engine.sweep.half_warp convention: G~ = invexpK_half @ G @ expK_half
    # (invexpK_half IS expm(+dtau K/2); expK = expm(-dtau K))
    left = nm.from_f64(model64.invexpK_half)
    right = nm.from_f64(model64.expK_half)

    def one(fields):
        # one chain per stored flavor (repulsive: opposite couplings,
        # models/repulsive_hubbard.expV_diag; attractive: a single +
        # flavor reused for both spins, model.h:50)
        Gs = []
        for sign in _flavor_signs(model64):
            G, _ = rebuild_chain(model64, cfg, fields, nm,
                                 flavor_sign=sign)
            if symmetric:
                G = nm.matmul(nm.matmul(left, G), right)
            Gs.append(nm.to_f64(G))
        return jnp.stack(Gs)                        # (nfl, ns, ns)

    return lambda states: jax.vmap(one)(states.fields)


# ----------------------------------------------------------------------
# Replica-stacked tier constructors (parallel tempering)
# ----------------------------------------------------------------------
#
# PT runs one model per leading-axis slot (one beta per replica,
# parallel/walkers.stack_models).  The reference's PT ranks measure
# through the same full-grade path as any rank (update.cpp:47-117 +
# measurementh5.h) — these wrappers give our PT driver the same
# property: the measurement tier vmaps over (model, fields) pairs, so
# each replica's G is rebuilt with ITS OWN beta's expK/g at nm grade.


def measurement_greens_fn_stacked(models64, cfg: EngineConfig, nm, *,
                                  symmetric: bool = False,
                                  n_stab: int | None = None):
    """Replica-stacked twin of :func:`measurement_greens_fn`.

    ``models64``: a stacked f64 model pytree (leading axis = replicas).
    Returns ``greens_fn(states) -> G (R, nfl, ns, ns) f64`` where
    replica r's equal-time G is rebuilt from its fields with its own
    model constants (beta-dependent expK / g ride the vmap axis through
    the traced-tolerant ``_expv_table_f64``).
    """
    _check_model(models64)
    if n_stab is None:
        from dqmc_tpu.ops import tf32 as _tf32
        n_stab = 2 * cfg.n_stab if nm is _tf32 else cfg.n_stab
    if cfg.nt % n_stab != 0:
        n_stab = cfg.n_stab
    import dataclasses as _dc
    cfg = _dc.replace(cfg, n_stab=n_stab)
    signs = _flavor_signs(models64)

    def one(m64, fields):
        left = nm.from_f64(m64.invexpK_half)
        right = nm.from_f64(m64.expK_half)
        Gs = []
        for sign in signs:
            G, _ = rebuild_chain(m64, cfg, fields, nm, flavor_sign=sign)
            if symmetric:
                G = nm.matmul(nm.matmul(left, G), right)
            Gs.append(nm.to_f64(G))
        return jnp.stack(Gs)                        # (nfl, ns, ns)

    return lambda states: jax.vmap(one)(models64, states.fields)


def measurement_uneq_fn_stacked(models64, cfg: EngineConfig, nm,
                                measure_fn, *, symmetric: bool = False,
                                n_stab: int | None = None,
                                emit_greens: bool = False):
    """Replica-stacked twin of :func:`measurement_uneq_fn`.

    The per-replica fn is constructed INSIDE the replica vmap with the
    stride already resolved on concrete betas (the df32 stride cap uses
    the LARGEST beta in the ladder — largest dtau — so every replica
    keeps the advertised grade), which skips the only host-float branch
    of the underlying constructor.
    """
    _check_model(models64)
    if n_stab is None or n_stab <= 0:
        n_stab = cfg.n_stab
        if nm is df32:
            dtau = float(np.max(np.asarray(models64.beta))) / cfg.nt
            n_stab = max(1, min(n_stab, int(0.4 / dtau)))
    n_stab = _divisor_stride(cfg.nt, n_stab)
    import types as _types

    def one(m64, fields):
        fn = measurement_uneq_fn(m64, cfg, nm, measure_fn,
                                 symmetric=symmetric, n_stab=n_stab,
                                 emit_greens=emit_greens, use_scan=True)
        out = fn(_types.SimpleNamespace(fields=fields[None]))
        return jax.tree_util.tree_map(lambda a: a[0], out)

    return lambda states: jax.vmap(one)(models64, states.fields)
