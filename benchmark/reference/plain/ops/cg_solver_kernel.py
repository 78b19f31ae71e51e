"""Fused smooth + CG (+ Euler) constraint solves: CUDA kernels, wrappers, plain versions.

Two kernels, one per friction-cone type, built with the other csrc/ kernels
into one library (ops/kernel_lib.py):

`cg_solve` (csrc/cg_solve.cu) replaces the TPU kernel
track_mjx_tpu/ops/cg_solver_kernel.py::_cg_kernel, launched through
`_cg_solve_tpu`, in its production configuration (qM built from the CRB
factors, J built from the compact per-contact operands, Euler
implicit-damping solve fused): unilateral limit and pyramid rows, the
rodent. Per env it builds qM and J, factors qM, solves qacc_smooth, picks
the cheaper of the warm and smooth starts, runs `iterations`
M-preconditioned Polak-Ribiere CG steps with an `ls_iterations` Newton
linesearch (jar and M dx advance by incremental axpy updates, as MuJoCo's
mj_solCG does), extracts force and qfrc, and solves qacc_eff = (M +
diag(hd))^-1 (qfrc_smooth + qfrc) from a second factor. The substitutions go
through the 8x8 panel-diagonal inverses.

`ell_cg_solve` (csrc/ell_cg_solve.cu) replaces `_ell_cg_kernel`, launched
through `_ell_cg_solve_tpu`, in the same configuration: limit rows plus one
(normal, t1, t2) elliptic cone block per contact, the fly. Force, cost and
linesearch curvature follow the three-zone cone projection; the linesearch
is the safeguarded, bracketed Newton search that never accepts a step that
raises the cost. It keeps the JAX kernel's numerics on purpose: the exact
panel substitution (no panel inverses), and jar = J x - aref and M (x -
smooth) recomputed from x every iteration with M read directly, because the
bracket decisions (d1 < 0) flip under reassociation.

On the H100 both kernels are bound by a serial dependency chain per env, not
by bytes or flops: factorizations and (L L^T)^-1 applies are chains of
dependent steps, over operands (J, qM, L) that live in shared memory for the
whole solve. Both keep one env per CTA with everything in shared memory, so
device memory is read once (the compact operands) and written once (the
outputs). Both kernels were redesigned to shorten the chain
(csrc/cg_solve.cu, csrc/ell_cg_solve.cu): qM and its factors in
lower-triangle tiles, factored by the standalone cholesky kernel's tiled
factor; J compact (each limit row one dof, each contact its three frame
rows; `cg_solve` forms the pyramid rows inside the products with the dense
build's arithmetic); the (L L^T)^-1 applies on one warp with no CTA
barrier (`cg_solve` through the panel inverses, `ell_cg_solve` by the
exact substitution); each reduction behind one barrier. Each keeps its
first design's float32 operations in their order, reductions included, so
its outputs are its first design's bit for bit (the elliptic linesearch is
a knife edge under reassociation). Both take n <= MAX_N
(batched_linalg.MAX_N).

`cg_solve_dense` (csrc/cg_solve.cu built with kDense) replaces the same TPU
kernel in its dense-J mode (`_cg_kernel` with jb_dims None): K2's solve over
a dense J [B, nefc, nv], the rows of pyramidal plans with condim-1, -4 or -6
contacts. `ell_cg_solve_dense` (csrc/ell_cg_solve.cu built with kDense)
replaces `_ell_cg_kernel` with jb None: K3's solve over a dense J whose
first `ns` rows are unilateral scalar rows of any content (limits, condim-1
contacts) and the rest cone blocks, the rows of elliptic plans with
condim-1 contacts. Both dense modes leave J in device memory and walk it in
panels of rows through two slots of shared memory (csrc/j_panels.cuh;
`j_panels` gives the panels), with the resident J's float operations in
their order. Without `with_euler` (RK4 and implicit plans, the TPU
kernels' hd=None) all four skip the Euler solve.

`cg_solve`, `cg_solve_dense`, `ell_cg_solve` and `ell_cg_solve_dense` are
the wrappers: they check their arguments, run the plain version for CPU
tensors and launch the kernel for CUDA tensors, raising if the build or the
launch fails. `<wrapper>.launches` counts kernel launches. `cg_solve_plain`,
`cg_solve_dense_plain`, `ell_cg_solve_plain` and `ell_cg_solve_dense_plain`
are the same computations in batched torch; the tests and chip_smoke.py
compare the kernels with them. `scalar_cg` is the reference's unfused
per-env CG batched, with the force bounds of equality and frictionloss rows:
the bounded CG of physics/solver.py runs it. `elliptic_cg` is the
reference's general elliptic CG batched (bounded scalar rows beside cone
blocks, the safeguarded linesearch over both): physics/solver.py runs it on
elliptic plans with equality or frictionloss rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.plain.ops.batched_linalg import (
    MAX_N,
    blocked_substitution,
    blocked_substitution_pinv,
    factor,
    invert_diag_blocks,
)

_EPS = 1e-12
# Finite stand-in for an unbounded force limit (the reference's BIG_FORCE):
# equality rows are bilateral (never clamped). Well under the float32
# maximum, so no product overflows.
BIG_FORCE = 1e30


# The dense modes' walks over J (csrc/j_panels.cuh): the slots in shared
# memory and the floats they may take in each kernel (cg_solve.cu's and
# ell_cg_solve.cu's kJRingFloats).
J_SLOTS = 2
J_RING_FLOATS = {"cg_solve_dense": 10240, "ell_cg_solve_dense": 3400}


class JPanels(NamedTuple):
    rows: int  # the most rows a panel holds
    cuts: tuple  # panel k holds rows cuts[k] .. cuts[k + 1] - 1
    resident: bool  # J copied once, whole (no more panels than slots)


def j_panels(op: str, n: int, e: int, ns: int | None = None) -> JPanels:
    """The panels in which `op` (cg_solve_dense, ell_cg_solve_dense) walks a
    dense J of e rows of n, the first ns of one row each and the rest cone
    blocks of 3 (ns None: every row its own), as csrc/j_panels.cuh cuts
    them: at most `rows` rows a panel (a slot holds rows x n floats and 3
    more), a multiple of 3 where there are cone blocks, each
    boundary at min(e, k rows) rounded down to the start of a cone block."""
    ns = e if ns is None else ns
    step = 3 if ns < e else 1
    rows = max(step, (J_RING_FLOATS[op] // J_SLOTS - 4) // n // step * step)
    count = -(-e // rows)

    def cut(k):
        r = min(e, k * rows)
        return r if r <= ns else ns + (r - ns) // 3 * 3

    return JPanels(rows, tuple(cut(k) for k in range(count + 1)), count <= J_SLOTS)


class CGOut(NamedTuple):
    qacc_smooth: torch.Tensor  # [B, n]
    qacc: torch.Tensor  # [B, n]
    efc_force: torch.Tensor  # [B, e], efc row order
    qfrc_constraint: torch.Tensor  # [B, n]
    qacc_eff: torch.Tensor | None  # [B, n]; None without the Euler solve


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def assemble_qm(buf, cdof, anc, armature) -> torch.Tensor:
    """qM[i, j] = buf[i] . cdof[j] for j ancestor-or-self of i, mirrored to
    the upper triangle, plus diag(armature). buf/cdof [B, n, 6], anc (n, n)
    0/1 float, armature (n,) shared or [B, n] per env -> [B, n, n]."""
    lower = (buf @ cdof.transpose(-1, -2)) * anc
    diag = torch.diagonal(lower, dim1=-2, dim2=-1)
    return lower + lower.transpose(-1, -2) - torch.diag_embed(diag) + (
        torch.diag(armature) if armature.dim() == 1 else torch.diag_embed(armature)
    )


def _jfr(fq, sw, dm) -> torch.Tensor:
    """Frame-projected contact rows [B, nc, 3, n]:
    jfr[c, k, d] = (sum_j fq[c, k, j] sw[d, j]) dm[c, d]."""
    return torch.einsum("bckj,bdj->bckd", fq, sw) * dm[None, :, None, :]


def build_j(fq, sw, ll, mu, dm, lim1h) -> torch.Tensor:
    """Dense J [B, nl + 4 nc, n] in efc row order from the compact operands:
    limit rows lim1h * ll, then per contact the pyramid rows
    jfr0 + mu0 jfr1, jfr0 - mu0 jfr1, jfr0 + mu1 jfr2, jfr0 - mu1 jfr2."""
    bsz = fq.shape[0]
    jfr = _jfr(fq, sw, dm)
    m0, m1 = mu[..., 0, None], mu[..., 1, None]
    j0, j1, j2 = jfr[:, :, 0], jfr[:, :, 1], jfr[:, :, 2]
    pyr = torch.stack([j0 + m0 * j1, j0 - m0 * j1, j0 + m1 * j2, j0 - m1 * j2], dim=2)
    lim = lim1h[None] * ll[:, :, None]
    return torch.cat([lim, pyr.reshape(bsz, -1, sw.shape[1])], dim=1)


def cg_solve_plain(
    buf, cdof, fq, sw, ll, mu, aref, D, qfrc_smooth, warm, hd, tolscale,
    anc, arm, dm, lim1h, *, iterations: int, ls_iterations: int, with_euler: bool = True,
) -> CGOut:
    """The kernel's computation in batched torch (any device)."""
    j = build_j(fq, sw, ll, mu, dm, lim1h)
    return _pyramidal_plain(assemble_qm(buf, cdof, anc, arm), j, aref, D, qfrc_smooth, warm, hd, tolscale,
                            iterations, ls_iterations, with_euler)


def cg_solve_dense_plain(
    buf, cdof, J, aref, D, qfrc_smooth, warm, hd, tolscale, anc, arm, *,
    iterations: int, ls_iterations: int, with_euler: bool,
) -> CGOut:
    """The dense-J kernel's computation in batched torch (any device): K2's
    schedule, `cg_solve_plain`'s, over a given J, as the reference's dense-J
    TPU kernel (_cg_kernel with jb_dims None) computes it. The reference's
    unfused per-env solve, `_smooth_scalar_cg_single`, is `scalar_cg`
    between a factor and a substitution of qM (tests/test_torch_condim.py
    holds the two together)."""
    return _pyramidal_plain(assemble_qm(buf, cdof, anc, arm), J, aref, D, qfrc_smooth, warm, hd, tolscale,
                            iterations, ls_iterations, with_euler)


def _pyramidal_plain(qm, j, aref, D, qfrc_smooth, warm, hd, tolscale, iterations, ls_iterations,
                     with_euler) -> CGOut:
    """K2's solve over qm [B, n, n] and the unilateral rows of j [B, e, n]:
    factor, smooth solve, the cheaper start, PR-CG with jar and M dx
    advanced by increments, force and qfrc, and with_euler the (M +
    diag(hd)) solve; every (L L^T)^-1 apply through the panel inverses."""
    l = factor(qm)
    dinv = invert_diag_blocks(l)

    def chosolve(b):
        return blocked_substitution_pinv(l, dinv, b)

    def matv_j(x):
        return (j @ x[..., None])[..., 0]

    def matv_jt(f):
        return (f[:, None, :] @ j)[:, 0]

    def matv_m(v):
        return (qm @ v[..., None])[..., 0]

    def force_of(jar):
        return torch.where(jar < 0, -D * jar, torch.zeros_like(jar))

    def cost_rows(jar):
        return 0.5 * torch.where(jar < 0, D * jar * jar, torch.zeros_like(jar)).sum(-1)

    smooth = chosolve(qfrc_smooth)
    # warm vs smooth start, the cheaper per env; cost(smooth) has no
    # quadratic term, and both candidates' jar and M dx are kept for reuse
    jar_warm = matv_j(warm) - aref
    dxw = warm - smooth
    mdxw = matv_m(dxw)
    cost_warm = 0.5 * (dxw * mdxw).sum(-1) + cost_rows(jar_warm)
    jar_sm = matv_j(smooth) - aref
    take_warm = (cost_warm < cost_rows(jar_sm))[:, None]
    x = torch.where(take_warm, warm, smooth)
    jar = torch.where(take_warm, jar_warm, jar_sm)
    mdx = torch.where(take_warm, mdxw, torch.zeros_like(mdxw))
    grad = mdx - matv_jt(force_of(jar))
    mgrad = chosolve(grad)
    p = -mgrad
    imp = torch.ones_like(tolscale)

    for _ in range(iterations):
        mp = matv_m(p)
        jp = matv_j(p)
        pmp = (p * mp).sum(-1)
        dmx = (mp * (x - smooth)).sum(-1)

        def phi_derivs(alpha):
            jr = jar + alpha[:, None] * jp
            active = jr < 0
            zero = torch.zeros_like(jr)
            d1 = alpha * pmp + dmx + torch.where(active, D * jr * jp, zero).sum(-1)
            d2 = pmp + torch.where(active, D * jp * jp, zero).sum(-1)
            return d1, torch.clamp(d2, min=_EPS)

        d1, d2 = phi_derivs(torch.zeros_like(pmp))
        alpha = -d1 / d2
        for _ in range(ls_iterations):
            d1, d2 = phi_derivs(alpha)
            alpha = alpha - d1 / d2
        # converged envs freeze by taking zero-length steps
        alpha = alpha * imp
        x = x + alpha[:, None] * p
        jar = jar + alpha[:, None] * jp
        mdx = mdx + alpha[:, None] * mp
        gradn = mdx - matv_jt(force_of(jar))
        mgradn = chosolve(gradn)
        num = (gradn * (mgradn - mgrad)).sum(-1)
        den = torch.clamp((grad * mgrad).sum(-1), min=_EPS)
        beta = torch.clamp(num / den, min=0.0)
        p = -mgradn + beta[:, None] * p
        grad, mgrad = gradn, mgradn
        imp = imp * (torch.sqrt((gradn * gradn).sum(-1)) > tolscale).to(imp.dtype)

    force = force_of(jar)
    qfrc = matv_jt(force)
    if not with_euler:
        return CGOut(smooth, x, force, qfrc, None)
    l2 = factor(qm + torch.diag_embed(hd))
    dinv2 = invert_diag_blocks(l2)
    eff = blocked_substitution_pinv(l2, dinv2, qfrc_smooth + qfrc)
    return CGOut(smooth, x, force, qfrc, eff)


def scalar_zone(jar, d, fmin=None, fmax=None):
    """Force of scalar rows, clip(-D jar, fmin, fmax), and their
    quadratic-zone mask fmin < -D jar < fmax (strict). Bounds None are those
    of unilateral rows, (0, BIG_FORCE): the force is where(jar < 0, -D jar,
    0). Equality rows (fmin -BIG_FORCE) never clamp; frictionloss rows
    saturate at +-frictionloss."""
    lo = 0.0 if fmin is None else fmin
    hi = BIG_FORCE if fmax is None else fmax
    f_un = -d * jar
    return f_un.clamp(min=lo).clamp(max=hi), (f_un > lo) & (f_un < hi)


def scalar_cost(jar, d, fmin=None, fmax=None):
    """Per-row cost of scalar rows (bounds as in `scalar_zone`): quadratic
    inside the force box, linear outside (|f| |jar| - f^2 / (2 D),
    continuous at its edge; 0 for an inactive unilateral row)."""
    f, quad = scalar_zone(jar, d, fmin, fmax)
    lin = -f * jar - 0.5 * f * f / torch.clamp(d, min=_EPS)
    return torch.where(quad, 0.5 * d * jar * jar, lin)


def scalar_linesearch(jar0, jp, pmp, dmx, d, fmin, fmax, ls_iterations: int):
    """Newton linesearch on phi(alpha) along p over scalar rows (bounds as
    in `scalar_zone`), with exact derivatives: phi' is piecewise linear in
    alpha and plain Newton (no bracket) is the reference's scalar-row
    search. jar0 = J x - aref and jp = J p [B, e], pmp = p.M p and dmx =
    p.M (x - smooth) [B]. A row adds D jar jp to phi' in its quadratic zone
    and -f jp outside it. Returns alpha [B]."""

    def phi_derivs(alpha):
        jar = jar0 + alpha[:, None] * jp
        f, quad = scalar_zone(jar, d, fmin, fmax)
        d1 = alpha * pmp + dmx + torch.where(quad, d * jar * jp, -f * jp).sum(-1)
        d2 = pmp + torch.where(quad, d * jp * jp, torch.zeros_like(jp)).sum(-1)
        return d1, torch.clamp(d2, min=_EPS)

    d1, d2 = phi_derivs(torch.zeros_like(pmp))
    alpha = -d1 / d2
    for _ in range(ls_iterations):
        d1, d2 = phi_derivs(alpha)
        alpha = alpha - d1 / d2
    return alpha


def scalar_cg(qm, chosolve, j, aref, D, smooth, warm, tolscale, *, iterations: int,
              ls_iterations: int, fmin=None, fmax=None):
    """M-preconditioned Polak-Ribiere CG over scalar rows, every product
    fresh from x: the batched form of the reference's per-env
    `_scalar_cg_single` (track_mjx_tpu/physics/solver.py). qm [B, n, n],
    chosolve(b) = qm^-1 b, j [B, e, n], aref and D [B, e], smooth and warm
    [B, n], tolscale [B] (tolerance times trace qm). fmin and fmax [e] (or
    [B, e], a frictionloss randomized per env) bound the rows' forces
    (equality and frictionloss rows); None leaves them unilateral. The cheaper of warm and smooth starts; an env whose gradient
    at the start of an iteration is under tolscale keeps its state from then
    on. Returns (qacc, force, qfrc_constraint)."""

    def matv(a, v):
        return (a @ v[..., None])[..., 0]

    def cost(x):
        dx = x - smooth
        rows = scalar_cost(matv(j, x) - aref, D, fmin, fmax).sum(-1)
        return 0.5 * (dx * matv(qm, dx)).sum(-1) + rows

    def cost_grad(x):
        jar = matv(j, x) - aref
        grad = matv(qm, x - smooth) - matv(j.transpose(-1, -2), scalar_zone(jar, D, fmin, fmax)[0])
        return jar, grad

    def linesearch(x, p):
        pmp = (p * matv(qm, p)).sum(-1)
        dmx = (p * matv(qm, x - smooth)).sum(-1)
        return scalar_linesearch(matv(j, x) - aref, matv(j, p), pmp, dmx, D, fmin, fmax, ls_iterations)

    x = torch.where((cost(warm) < cost(smooth))[:, None], warm, smooth)
    jar, grad = cost_grad(x)
    mgrad = chosolve(grad)
    p = -mgrad
    improved = torch.ones_like(tolscale, dtype=torch.bool)
    for _ in range(iterations):
        alpha = linesearch(x, p)
        xn = x + alpha[:, None] * p
        jarn, gradn = cost_grad(xn)
        mgradn = chosolve(gradn)
        num = (gradn * (mgradn - mgrad)).sum(-1)
        den = torch.clamp((grad * mgrad).sum(-1), min=_EPS)
        beta = torch.clamp(num / den, min=0.0)
        pn = -mgradn + beta[:, None] * p
        keep = improved[:, None]
        x, jar = torch.where(keep, xn, x), torch.where(keep, jarn, jar)
        grad, mgrad = torch.where(keep, gradn, grad), torch.where(keep, mgradn, mgrad)
        p = torch.where(keep, pn, p)
        improved = torch.where(improved, torch.sqrt((gradn * gradn).sum(-1)) > tolscale, improved)
    force = scalar_zone(jar, D, fmin, fmax)[0]
    return x, force, matv(j.transpose(-1, -2), force)


def build_j_ell(fq, sw, ll, dm, lim1h) -> torch.Tensor:
    """Dense J [B, nl + 3 nc, n] in efc row order from the compact operands:
    limit rows lim1h * ll, then per contact the cone block's rows jfr0, jfr1,
    jfr2 (normal, t1, t2), the frame-projected rows themselves."""
    bsz = fq.shape[0]
    lim = lim1h[None] * ll[:, :, None]
    return torch.cat([lim, _jfr(fq, sw, dm).reshape(bsz, -1, sw.shape[1])], dim=1)


class _Cones(NamedTuple):
    """Per-env cone constants: D and sqrt(D) of each block's rows [B, nc, 3],
    effective friction mu = mu_1 / sqrt(impratio) and 1 + mu^2 [B, nc]."""

    d: torch.Tensor
    sq: torch.Tensor
    mu: torch.Tensor
    mu2p1: torch.Tensor

    def zones(self, u):
        """Zone geometry of cone blocks u [B, nc, 3] (jar of the block rows):
        p = -sqrt(D) u, tangential norm t, bottom (inside the cone, static
        friction), top (separating), and s* for the middle zone."""
        p = -self.sq * u
        p_n, p_t1, p_t2 = p.unbind(-1)
        t = torch.sqrt(torch.clamp(p_t1 * p_t1 + p_t2 * p_t2, min=_EPS * _EPS))
        bottom = self.mu * p_n >= t
        top = p_n <= -self.mu * t
        s_star = (p_n + self.mu * t) / self.mu2p1
        return p, t, bottom, top, s_star

    def force(self, u):
        """Cone projection force of the blocks [B, nc, 3]."""
        p, t, bottom, top, s_star = self.zones(u)
        coef = self.mu * s_star / t
        sq_n, sq_t1, sq_t2 = self.sq.unbind(-1)
        mid = torch.stack(
            [sq_n * s_star, sq_t1 * coef * p[..., 1], sq_t2 * coef * p[..., 2]], dim=-1
        )
        zero = torch.zeros_like(u)
        return torch.where(bottom[..., None], -self.d * u, torch.where(top[..., None], zero, mid))

    def cost(self, u):
        """Summed cone cost of the blocks [B]."""
        p, t, bottom, top, _ = self.zones(u)
        quad = 0.5 * (p * p).sum(-1)
        mid = quad - 0.5 * (t - self.mu * p[..., 0]) ** 2 / self.mu2p1
        return torch.where(bottom, quad, torch.where(top, torch.zeros_like(quad), mid)).sum(-1)


def ell_cg_solve_plain(
    buf, cdof, fq, sw, ll, mu, aref, D, qfrc_smooth, warm, hd, tolscale,
    anc, arm, dm, lim1h, *, iterations: int, ls_iterations: int, with_euler: bool = True,
) -> CGOut:
    """The elliptic kernel's computation in batched torch (any device)."""
    qm = assemble_qm(buf, cdof, anc, arm)
    j = build_j_ell(fq, sw, ll, dm, lim1h)
    return _elliptic_plain(qm, j, aref, D, mu, qfrc_smooth, warm, hd, tolscale, lim1h.shape[0], iterations,
                           ls_iterations, with_euler)


def ell_cg_solve_dense_plain(
    buf, cdof, J, aref, D, mu, qfrc_smooth, warm, hd, tolscale, anc, arm, *,
    ns: int, with_euler: bool, iterations: int, ls_iterations: int,
) -> CGOut:
    """The dense-J elliptic kernel's computation in batched torch (any
    device): K3's schedule, `ell_cg_solve_plain`'s, over a given J whose
    first `ns` rows are unilateral scalar rows (limits, condim-1 contacts)
    and the rest cone blocks, as the reference's dense-J TPU kernel
    (_ell_cg_kernel with jb None) computes it."""
    return _elliptic_plain(assemble_qm(buf, cdof, anc, arm), J, aref, D, mu, qfrc_smooth, warm, hd, tolscale,
                           ns, iterations, ls_iterations, with_euler)


def _ell_linesearch(cones: _Cones, split, jarx, jp, pmp, dmx, scalar_terms, cost_rows, ls_iterations: int):
    """Safeguarded Newton on phi(alpha) along p: keeps a bracket [lo, hi]
    with phi'(lo) < 0 <= phi'(hi); a Newton step outside it falls back to
    bisection, or to doubling while no upper end is known; a step that does
    not lower phi is refused. jarx = J x - aref and jp = J p [B, e], pmp =
    p.M p and dmx, M p . (x - smooth) [B]; split(v) gives a row vector's
    scalar rows and cone blocks [B, nc, 3]; scalar_terms(jar_s, jp_s) the
    scalar rows' terms of phi' and phi'' [B]; cost_rows(jar) the rows'
    summed cost [B]. Returns alpha [B]."""
    jp_s, jp_b = split(jp)
    q = -cones.sq * jp_b
    q_n, q_t1, q_t2 = q.unbind(-1)
    qq = q_n * q_n + q_t1 * q_t1 + q_t2 * q_t2
    qq_t = q_t1 * q_t1 + q_t2 * q_t2
    h_bot = (cones.d * jp_b * jp_b).sum(-1)

    def phi_derivs(alpha):
        jar = jarx + alpha[:, None] * jp
        jar_s, u = split(jar)
        s1, s2 = scalar_terms(jar_s, jp_s)
        d1 = alpha * pmp + dmx + s1
        d2 = pmp + s2
        d1 = d1 - (jp_b * cones.force(u)).sum((-2, -1))
        pb, t, bottom, top, _ = cones.zones(u)
        t_p = (pb[..., 1] * q_t1 + pb[..., 2] * q_t2) / t
        t_pp = torch.clamp(qq_t - t_p * t_p, min=0.0) / t
        h_mid = qq - ((t_p - cones.mu * q_n) ** 2 + (t - cones.mu * pb[..., 0]) * t_pp) / cones.mu2p1
        h = torch.where(bottom, h_bot, torch.where(top, torch.zeros_like(h_mid), h_mid))
        return d1, torch.clamp(d2 + h.sum(-1), min=_EPS)

    big = torch.finfo(jarx.dtype).max
    d1, d2 = phi_derivs(torch.zeros_like(pmp))
    alpha = torch.clamp(-d1 / d2, min=0.0)
    lo, hi = torch.zeros_like(pmp), torch.full_like(pmp, big)
    for _ in range(ls_iterations):
        d1, d2 = phi_derivs(alpha)
        neg = d1 < 0
        lo = torch.where(neg, torch.maximum(lo, alpha), lo)
        hi = torch.where(neg, hi, torch.minimum(hi, alpha))
        newton = alpha - d1 / d2
        fallback = torch.where(hi < big, 0.5 * (lo + hi), 2.0 * alpha + 1e-9)
        alpha = torch.where((newton > lo) & (newton < hi), newton, fallback)
    dphi = 0.5 * alpha * alpha * pmp + alpha * dmx + cost_rows(jarx + alpha[:, None] * jp) - cost_rows(jarx)
    return torch.where(dphi < 0, alpha, torch.zeros_like(alpha))


def _ell_split(ns: int, nc: int):
    """split(v): a row vector [B, ns + 3 nc]'s scalar rows [B, ns] and cone
    blocks [B, nc, 3]."""
    return lambda v: (v[:, :ns], v[:, ns:].reshape(v.shape[0], nc, 3))


def _cones(D, mu, ns: int) -> _Cones:
    d_b = D[:, ns:].reshape(D.shape[0], -1, 3)
    mu = mu.expand(D.shape[0], d_b.shape[1])
    return _Cones(d=d_b, sq=torch.sqrt(d_b), mu=mu, mu2p1=1.0 + mu * mu)


def _elliptic_plain(qm, j, aref, D, mu, qfrc_smooth, warm, hd, tolscale, ns, iterations, ls_iterations,
                    with_euler) -> CGOut:
    """K3's solve over qm [B, n, n] and j [B, ns + 3 nc, n] (ns unilateral
    scalar rows, then the cone blocks): factor, smooth solve, the cheaper
    start, PR-CG with jar and M (x - smooth) afresh from x each iteration,
    force and qfrc, and with_euler the (M + diag(hd)) solve; every (L L^T)^-1
    apply the exact substitution."""
    nc = (j.shape[1] - ns) // 3
    l = factor(qm)
    d_s = D[:, :ns]
    cones = _cones(D, mu, ns)
    split = _ell_split(ns, nc)

    def chosolve(b):
        return blocked_substitution(l, b)

    def matv_j(x):
        return (j @ x[..., None])[..., 0]

    def matv_jt(f):
        return (f[:, None, :] @ j)[:, 0]

    def matv_m(v):
        return (qm @ v[..., None])[..., 0]

    def force_of(jar):
        jar_s, u = split(jar)
        f_s = torch.where(jar_s < 0, -d_s * jar_s, torch.zeros_like(jar_s))
        return torch.cat([f_s, cones.force(u).reshape(jar.shape[0], -1)], dim=1)

    def cost_rows(jar):
        jar_s, u = split(jar)
        cs = 0.5 * torch.where(jar_s < 0, d_s * jar_s * jar_s, torch.zeros_like(jar_s)).sum(-1)
        return cs + cones.cost(u)

    def scalar_terms(jar_s, jp_s):
        active = jar_s < 0
        zero = torch.zeros_like(jar_s)
        return (torch.where(active, d_s * jar_s * jp_s, zero).sum(-1),
                torch.where(active, d_s * jp_s * jp_s, zero).sum(-1))

    def linesearch(x, p, jarx):
        mp = matv_m(p)
        return _ell_linesearch(cones, split, jarx, matv_j(p), (p * mp).sum(-1), (mp * (x - smooth)).sum(-1),
                               scalar_terms, cost_rows, ls_iterations)

    smooth = chosolve(qfrc_smooth)
    # warm vs smooth start, the cheaper per env; cost(smooth) has no
    # quadratic term
    jar_warm = matv_j(warm) - aref
    dxw = warm - smooth
    mdxw = matv_m(dxw)
    cost_warm = 0.5 * (dxw * mdxw).sum(-1) + cost_rows(jar_warm)
    jar_sm = matv_j(smooth) - aref
    take_warm = (cost_warm < cost_rows(jar_sm))[:, None]
    x = torch.where(take_warm, warm, smooth)
    jar = torch.where(take_warm, jar_warm, jar_sm)
    mdx = torch.where(take_warm, mdxw, torch.zeros_like(mdxw))
    grad = mdx - matv_jt(force_of(jar))
    mgrad = chosolve(grad)
    p = -mgrad
    imp = torch.ones_like(tolscale)

    for _ in range(iterations):
        # converged envs freeze by taking zero-length steps
        alpha = linesearch(x, p, jar) * imp
        x = x + alpha[:, None] * p
        # jar and M (x - smooth) afresh from x, not by increments
        jar = matv_j(x) - aref
        gradn = matv_m(x - smooth) - matv_jt(force_of(jar))
        mgradn = chosolve(gradn)
        num = (gradn * (mgradn - mgrad)).sum(-1)
        den = torch.clamp((grad * mgrad).sum(-1), min=_EPS)
        beta = torch.clamp(num / den, min=0.0)
        p = -mgradn + beta[:, None] * p
        grad, mgrad = gradn, mgradn
        imp = imp * (torch.sqrt((gradn * gradn).sum(-1)) > tolscale).to(imp.dtype)

    force = force_of(jar)
    qfrc = matv_jt(force)
    if not with_euler:
        return CGOut(smooth, x, force, qfrc, None)
    eff = blocked_substitution(factor(qm + torch.diag_embed(hd)), qfrc_smooth + qfrc)
    return CGOut(smooth, x, force, qfrc, eff)


def elliptic_cg(qm, chosolve, J, aref, D, fmin, fmax, mu_t, smooth, warm, tolscale, *, ns: int,
                iterations: int, ls_iterations: int):
    """M-preconditioned Polak-Ribiere CG over bounded scalar rows and
    elliptic cone blocks, every product fresh from x: the batched form of
    the reference's general elliptic path (track_mjx_tpu/physics/solver.py,
    `solve` for elliptic plans with equality or frictionloss rows). qm
    [B, n, n], chosolve(b) = qm^-1 b, J [B, ns + 3 nc, n] (ns scalar rows:
    equality, frictionloss, limits, condim-1 contacts; then the cone
    blocks), aref and D [B, e], fmin and fmax [e] or [B, e] (the scalar
    rows' force bounds, `scalar_zone`), mu_t [B, nc] or [nc] (mu_1 / sqrt(impratio)),
    smooth and warm [B, n], tolscale [B] (tolerance times trace qm). The
    cheaper of warm and smooth by the full cost;
    the safeguarded linesearch over both row kinds; an env whose gradient at
    the start of an iteration is under tolscale keeps its state from then
    on. Returns (qacc, force, qfrc_constraint)."""
    nc = (J.shape[1] - ns) // 3
    d_s, fmin_s, fmax_s = D[:, :ns], fmin[..., :ns], fmax[..., :ns]
    cones = _cones(D, mu_t, ns)
    split = _ell_split(ns, nc)

    def matv(a, v):
        return (a @ v[..., None])[..., 0]

    def force_of(jar):
        jar_s, u = split(jar)
        f_s = scalar_zone(jar_s, d_s, fmin_s, fmax_s)[0]
        return torch.cat([f_s, cones.force(u).reshape(jar.shape[0], -1)], dim=1)

    def cost_rows(jar):
        jar_s, u = split(jar)
        return scalar_cost(jar_s, d_s, fmin_s, fmax_s).sum(-1) + cones.cost(u)

    def scalar_terms(jar_s, jp_s):
        f, quad = scalar_zone(jar_s, d_s, fmin_s, fmax_s)
        return (torch.where(quad, d_s * jar_s * jp_s, -f * jp_s).sum(-1),
                torch.where(quad, d_s * jp_s * jp_s, torch.zeros_like(jp_s)).sum(-1))

    def cost(x):
        dx = x - smooth
        return 0.5 * (dx * matv(qm, dx)).sum(-1) + cost_rows(matv(J, x) - aref)

    def cost_grad(x):
        jar = matv(J, x) - aref
        return jar, matv(qm, x - smooth) - matv(J.transpose(-1, -2), force_of(jar))

    x = torch.where((cost(warm) < cost(smooth))[:, None], warm, smooth)
    jar, grad = cost_grad(x)
    mgrad = chosolve(grad)
    p = -mgrad
    improved = torch.ones_like(tolscale, dtype=torch.bool)
    for _ in range(iterations):
        alpha = _ell_linesearch(cones, split, matv(J, x) - aref, matv(J, p), (p * matv(qm, p)).sum(-1),
                                (p * matv(qm, x - smooth)).sum(-1), scalar_terms, cost_rows, ls_iterations)
        xn = x + alpha[:, None] * p
        jarn, gradn = cost_grad(xn)
        mgradn = chosolve(gradn)
        num = (gradn * (mgradn - mgrad)).sum(-1)
        den = torch.clamp((grad * mgrad).sum(-1), min=_EPS)
        beta = torch.clamp(num / den, min=0.0)
        pn = -mgradn + beta[:, None] * p
        keep = improved[:, None]
        x, jar = torch.where(keep, xn, x), torch.where(keep, jarn, jar)
        grad, mgrad = torch.where(keep, gradn, grad), torch.where(keep, mgradn, mgrad)
        p = torch.where(keep, pn, p)
        improved = torch.where(improved, torch.sqrt((gradn * gradn).sum(-1)) > tolscale, improved)
    force = force_of(jar)
    return x, force, matv(J.transpose(-1, -2), force)


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------


_ARG_NAMES = ("buf", "cdof", "fq", "sw", "ll", "mu", "aref", "D", "qfrc_smooth", "warm",
              "hd", "tolscale", "anc", "arm", "dm", "lim1h")
_DENSE_ARG_NAMES = ("buf", "cdof", "J", "aref", "D", "qfrc_smooth", "warm", "hd", "tolscale", "anc", "arm")
_ELL_DENSE_ARG_NAMES = ("buf", "cdof", "J", "aref", "D", "mu", "qfrc_smooth", "warm", "hd", "tolscale", "anc",
                        "arm")


def _compact_shapes(named: dict, rows_per_con: int):
    """The shapes of a compact solve's arguments, and its dims (n, nl, nc)
    and row count."""
    bsz, n = named["qfrc_smooth"].shape[0], named["qfrc_smooth"].shape[-1]
    nc, nl = named["fq"].shape[1], named["lim1h"].shape[0]
    e = nl + rows_per_con * nc
    per_env = dict(buf=(n, 6), cdof=(n, 6), fq=(nc, 3, 6), sw=(n, 6), ll=(nl,),
                   mu=(nc, 2) if rows_per_con == 4 else (nc,))
    static = dict(anc=(n, n), dm=(nc, n), lim1h=(nl, n))
    return per_env, static, (n, nl, nc), e


def _dense_shapes(named: dict):
    """The shapes of cg_solve_dense's arguments, its dims (n, e) and row
    count e."""
    n, j = named["qfrc_smooth"].shape[-1], named["J"]
    e = j.shape[1] if j.dim() == 3 else -1
    if e == 0:
        raise ValueError("cg_solve_dense: empty row set")
    return dict(buf=(n, 6), cdof=(n, 6), J=(e, n)), dict(anc=(n, n)), (n, e), e


def _ell_dense_shapes(named: dict, ns: int):
    """The shapes of ell_cg_solve_dense's arguments, its dims (n, ns, nc)
    and row count ns + 3 nc, nc the cone blocks of `mu`."""
    n, mu = named["qfrc_smooth"].shape[-1], named["mu"]
    nc = mu.shape[1] if mu.dim() == 2 else -1
    e = ns + 3 * nc
    if ns < 0 or nc < 0 or e == 0:
        raise ValueError(f"ell_cg_solve_dense: bad row counts ns = {ns}, mu {tuple(mu.shape)}")
    return dict(buf=(n, 6), cdof=(n, 6), J=(e, n), mu=(nc,)), dict(anc=(n, n)), (n, ns, nc), e


def _check(op: str, names, args, shapes):
    """Validates a solve's arguments (in `names` order): contiguous tensors
    on one device, float32 (float64 too on the CPU, a reference solve),
    of the shapes `shapes(named)` gives (per env and static, besides aref
    and D [B, e], qfrc_smooth, warm and hd [B, n], tolscale [B], and arm
    (n,) shared by every env or [B, n] per env). Returns (B, dims, e)."""
    named = dict(zip(names, args))
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{op}: {name} must be a tensor")
    bsz = named["qfrc_smooth"].shape[0]
    per_env, static, dims, e = shapes(named)
    n = dims[0]
    want = dict(static, aref=(bsz, e), D=(bsz, e), qfrc_smooth=(bsz, n), warm=(bsz, n), hd=(bsz, n),
                tolscale=(bsz,), arm=(bsz, n) if named["arm"].dim() == 2 else (n,),
                **{k: (bsz, *v) for k, v in per_env.items()})
    device = named["buf"].device
    dtype = torch.float64 if device.type == "cpu" and named["buf"].dtype == torch.float64 else torch.float32
    for name, t in named.items():
        if t.device != device:
            raise ValueError(f"{op}: {name} on {t.device}, buf on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{op}: {name} must be {dtype} like buf (float32, or float64 on the CPU), got {t.dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{op}: {name} shape {tuple(t.shape)}, expected {want[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
    if bsz == 0 or n == 0:
        raise ValueError(f"{op}: empty batch or model")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: unsupported device {device}")
    return bsz, dims, e


_NAMES = {"cg_solve": _ARG_NAMES, "ell_cg_solve": _ARG_NAMES, "cg_solve_dense": _DENSE_ARG_NAMES,
          "ell_cg_solve_dense": _ELL_DENSE_ARG_NAMES}


def cg_solve(
    buf, cdof, fq, sw, ll, mu, aref, D, qfrc_smooth, warm, hd, tolscale,
    anc, arm, dm, lim1h, *, iterations: int, ls_iterations: int, with_euler: bool = True,
) -> CGOut:
    """Fused smooth + CG (+ Euler) solve of a batch of envs, pyramidal rows.

    Per env: buf, cdof, sw [B, n, 6]; fq [B, nc, 3, 6]; ll [B, nl];
    mu [B, nc, 2]; aref, D [B, nl + 4 nc]; qfrc_smooth, warm, hd [B, n];
    tolscale [B]; arm [B, n], or (n,) shared by every env. Static: anc (n,
    n) 0/1, dm (nc, n), lim1h (nl, n) one-hot rows (each limit row's dof).
    All float32 and
    contiguous on one device. Without `with_euler` (plans on RK4 or an
    implicit integrator) M + diag(hd) is not factored and qacc_eff is None.
    CPU tensors run `cg_solve_plain` (in float64 too, as a reference); CUDA
    tensors launch the kernel (n <= MAX_N; a lim1h row with two nonzeros
    makes that env's J NaN) or raise."""
    args = (buf, cdof, fq, sw, ll, mu, aref, D, qfrc_smooth, warm, hd, tolscale,
            anc, arm, dm, lim1h)
    bsz, dims, e = _check("cg_solve", _ARG_NAMES, args, lambda named: _compact_shapes(named, 4))
    return cg_solve_plain(*args, iterations=iterations, ls_iterations=ls_iterations,
                          with_euler=with_euler)


def cg_solve_dense(
    buf, cdof, J, aref, D, qfrc_smooth, warm, hd, tolscale, anc, arm, *,
    with_euler: bool, iterations: int, ls_iterations: int,
) -> CGOut:
    """Fused smooth + CG (+ Euler) solve of a batch of envs over a dense J:
    the unilateral scalar rows of pyramidal plans off the compact layout
    (condim-1, -4 or -6 contacts beside the limits), in efc order.

    Per env: buf, cdof [B, n, 6]; J [B, e, n]; aref, D [B, e]; qfrc_smooth,
    warm, hd [B, n]; tolscale [B]; arm [B, n], or (n,) shared by every env.
    Static: anc (n, n) 0/1. All float32 and contiguous on one device.
    Without `with_euler` M + diag(hd) is not factored and qacc_eff is None.
    CPU tensors run `cg_solve_dense_plain` (in float64 too, as a reference); CUDA tensors
    launch the kernel (n <= MAX_N; J is walked in panels, `j_panels`, and
    the rows' vectors in shared memory bound e, about 8,000 rows at n = 73)
    or raise."""
    args = (buf, cdof, J, aref, D, qfrc_smooth, warm, hd, tolscale, anc, arm)
    bsz, dims, e = _check("cg_solve_dense", _DENSE_ARG_NAMES, args, _dense_shapes)
    return cg_solve_dense_plain(*args, iterations=iterations, ls_iterations=ls_iterations,
                                with_euler=with_euler)


def ell_cg_solve(
    buf, cdof, fq, sw, ll, mu, aref, D, qfrc_smooth, warm, hd, tolscale,
    anc, arm, dm, lim1h, *, iterations: int, ls_iterations: int, with_euler: bool = True,
) -> CGOut:
    """Fused smooth + elliptic CG (+ Euler) solve of a batch of envs: limit
    rows, then one (normal, t1, t2) cone block per contact, in efc order.

    Per env: buf, cdof, sw [B, n, 6]; fq [B, nc, 3, 6]; ll [B, nl];
    mu [B, nc] (mu_1 / sqrt(impratio) of each block); aref, D
    [B, nl + 3 nc]; qfrc_smooth, warm, hd [B, n]; tolscale [B]; arm [B, n],
    or (n,) shared by every env. Static: anc (n, n) 0/1, dm (nc, n), lim1h
    (nl, n). All float32 and
    contiguous on one device. Without `with_euler` (plans on RK4 or an
    implicit integrator) M + diag(hd) is not factored and qacc_eff is None.
    CPU tensors run `ell_cg_solve_plain` (in float64 too, as a reference);
    CUDA tensors launch the kernel (n <= MAX_N; a lim1h row with two
    nonzeros makes that env's J NaN) or raise."""
    args = (buf, cdof, fq, sw, ll, mu, aref, D, qfrc_smooth, warm, hd, tolscale,
            anc, arm, dm, lim1h)
    bsz, dims, e = _check("ell_cg_solve", _ARG_NAMES, args, lambda named: _compact_shapes(named, 3))
    return ell_cg_solve_plain(*args, iterations=iterations, ls_iterations=ls_iterations,
                              with_euler=with_euler)


def ell_cg_solve_dense(
    buf, cdof, J, aref, D, mu, qfrc_smooth, warm, hd, tolscale, anc, arm, *,
    ns: int, with_euler: bool, iterations: int, ls_iterations: int,
) -> CGOut:
    """Fused smooth + elliptic CG (+ Euler) solve of a batch of envs over a
    dense J: `ns` unilateral scalar rows (limits and condim-1 contacts),
    then one (normal, t1, t2) cone block per condim-3 contact, in efc order
    (elliptic plans with condim-1 contacts).

    Per env: buf, cdof [B, n, 6]; J [B, ns + 3 nc, n]; aref, D [B, ns + 3
    nc]; mu [B, nc] (mu_1 / sqrt(impratio) of each block); qfrc_smooth,
    warm, hd [B, n]; tolscale [B]; arm [B, n], or (n,) shared by every env.
    Static: anc (n, n) 0/1. All float32 and contiguous on one device.
    Without `with_euler` M + diag(hd) is not factored and qacc_eff is None.
    CPU tensors run `ell_cg_solve_dense_plain` (in float64 too, as a reference); CUDA tensors
    launch the kernel (n <= MAX_N; J is walked in panels of whole cone
    blocks, `j_panels`) or raise."""
    args = (buf, cdof, J, aref, D, mu, qfrc_smooth, warm, hd, tolscale, anc, arm)
    bsz, dims, e = _check("ell_cg_solve_dense", _ELL_DENSE_ARG_NAMES, args,
                          lambda named: _ell_dense_shapes(named, ns))
    return ell_cg_solve_dense_plain(*args, ns=ns, with_euler=with_euler, iterations=iterations,
                                    ls_iterations=ls_iterations)
