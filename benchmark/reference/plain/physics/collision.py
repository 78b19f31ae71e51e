"""Narrowphase collision over the static candidate pair table.

Port of track_mjx_tpu/physics/collision.py. The candidate pair set is fixed
on the host (PhysicsPlan.pair_groups), so every step has ncon contact slots;
an inactive contact carries a positive distance and draws no force. Pair
types: plane-sphere, plane-capsule, plane-ellipsoid, plane-box,
sphere-sphere, sphere-capsule, capsule-capsule (the rodent uses
plane-capsule and plane-ellipsoid, the fly plane-capsule and
capsule-capsule, with nonzero margins).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.plain.ops.quaternion import cross, dot
from benchmark.reference.plain.physics.model import (
    GEOM_BOX,
    GEOM_CAPSULE,
    GEOM_ELLIPSOID,
    GEOM_PLANE,
    GEOM_SPHERE,
    Data,
    Model,
    PhysicsPlan,
    static_tensor,
    take,
)


@dataclasses.dataclass(frozen=True)
class Contact:
    """Static-shape contact set, [B, ncon, ...] (friction, solref, solimp and
    includemargin depend only on the model and are [ncon, ...], or [B, ncon,
    ...] where a geom leaf they come from is per env: physics/model.py)."""

    dist: torch.Tensor  # [B, ncon]
    pos: torch.Tensor  # [B, ncon, 3]
    frame: torch.Tensor  # [B, ncon, 3, 3], rows = [normal, tangent1, tangent2]
    friction: torch.Tensor  # [ncon, 5] or [B, ncon, 5]
    solref: torch.Tensor  # [ncon, 2] or [B, ncon, 2]
    solimp: torch.Tensor  # [ncon, 5] or [B, ncon, 5]
    includemargin: torch.Tensor  # [ncon] or [B, ncon]


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


def make_frame(n: torch.Tensor) -> torch.Tensor:
    """Completes a right-handed frame from unit normals [..., 3] (mju_makeFrame)
    -> [..., 3, 3]."""
    ey = n.new_tensor([0.0, 1.0, 0.0])
    ez = n.new_tensor([0.0, 0.0, 1.0])
    ref = torch.where((torch.abs(n[..., 1]) < 0.5)[..., None], ey, ez)
    t1 = ref - n * dot(n, ref)[..., None]
    t1 = t1 / torch.clamp(_norm(t1), min=1e-12)[..., None]
    t2 = cross(n, t1)
    return torch.stack([n, t1, t2], dim=-2)


def _combine_params(model: Model, g1: torch.Tensor, g2: torch.Tensor):
    """Contact parameter mixing (mj_contactParam equal/priority rules), per
    pair [npair, ...], or [B, npair, ...] where a geom leaf is per env."""
    p1, p2 = take(model, "geom_priority", g1), take(model, "geom_priority", g2)
    s1, s2 = take(model, "geom_solmix", g1), take(model, "geom_solmix", g2)
    denom = s1 + s2
    mix = torch.where(denom > 1e-12, s1 / torch.clamp(denom, min=1e-12), 0.5)
    mix = torch.where((s1 < 1e-12) & (s2 >= 1e-12), 0.0, mix)
    mix = torch.where((s2 < 1e-12) & (s1 >= 1e-12), 1.0, mix)
    mix = torch.where(p1 > p2, 1.0, torch.where(p2 > p1, 0.0, mix))[..., None]

    ref1, ref2 = take(model, "geom_solref", g1), take(model, "geom_solref", g2)
    solref = torch.where(
        (ref1[..., :1] > 0) & (ref2[..., :1] > 0),
        mix * ref1 + (1 - mix) * ref2,
        torch.minimum(ref1, ref2),
    )
    solimp = mix * take(model, "geom_solimp", g1) + (1 - mix) * take(model, "geom_solimp", g2)

    f1, f2 = take(model, "geom_friction", g1), take(model, "geom_friction", g2)
    fri_pri = torch.where((p1 > p2)[..., None], f1, f2)
    fri3 = torch.where((p1 == p2)[..., None], torch.maximum(f1, f2), fri_pri)
    friction = torch.stack(
        [fri3[..., 0], fri3[..., 0], fri3[..., 1], fri3[..., 2], fri3[..., 2]], dim=-1
    )
    includemargin = take(model, "geom_margin", g1) + take(model, "geom_margin", g2)
    return friction, solref, solimp, includemargin


def _plane_sphere(n, ppos, c, r):
    dist = dot(n, c - ppos) - r
    pos = c - n * (r + 0.5 * dist)[..., None]
    return dist, pos


def collide(plan: PhysicsPlan, model: Model, data: Data) -> tuple[Data, Contact]:
    """Runs the narrowphase over all candidate pairs; returns fixed-shape
    contacts."""
    like = data.qpos
    bsz = like.shape[0]
    dists, poss, frames = [], [], []
    fris, refs, imps, margins = [], [], [], []

    for gi, (t1, t2, g1_np, g2_np) in enumerate(plan.pair_groups):
        g1 = static_tensor(plan, ("col", gi, 1), like, lambda: g1_np)
        g2 = static_tensor(plan, ("col", gi, 2), like, lambda: g2_np)
        npair = len(g1_np)
        fri, ref, imp, inc = _combine_params(model, g1, g2)
        x1, m1 = data.geom_xpos[:, g1], data.geom_xmat[:, g1]
        x2, m2 = data.geom_xpos[:, g2], data.geom_xmat[:, g2]
        sz1, sz2 = take(model, "geom_size", g1), take(model, "geom_size", g2)

        if (t1, t2) == (GEOM_PLANE, GEOM_SPHERE):
            n = m1[..., :, 2]
            d_, p_ = _plane_sphere(n, x1, x2, sz2[..., 0])
            con = [(d_, p_, make_frame(n))]
        elif (t1, t2) == (GEOM_PLANE, GEOM_CAPSULE):
            n = m1[..., :, 2]
            axis = m2[..., :, 2]
            hl, r = sz2[..., 1], sz2[..., 0]
            d1, p1 = _plane_sphere(n, x1, x2 + axis * hl[..., None], r)
            d2, p2 = _plane_sphere(n, x1, x2 - axis * hl[..., None], r)
            # mjc_PlaneCapsule frame: tangent1 = capsule axis projected onto
            # the plane (mju_makeFrame when near-vertical)
            proj = axis - n * dot(n, axis)[..., None]
            pn = _norm(proj)
            t1v = proj / torch.clamp(pn, min=1e-12)[..., None]
            frame_cap = torch.stack([n, t1v, cross(n, t1v)], dim=-2)
            frame_cap = torch.where((pn > 1e-9)[..., None, None], frame_cap, make_frame(n))
            con = [(d1, p1, frame_cap), (d2, p2, frame_cap)]
        elif (t1, t2) == (GEOM_PLANE, GEOM_ELLIPSOID):
            n = m1[..., :, 2]
            n_local = (m2 * n[..., :, None]).sum(-2)  # R2^T n
            sn = sz2 * n_local
            s = torch.clamp(_norm(sn), min=1e-12)
            support_local = -(sz2 * sn) / s[..., None]
            sp = x2 + (m2 * support_local[..., None, :]).sum(-1)
            d_ = dot(n, sp - x1)
            p_ = sp - 0.5 * d_[..., None] * n
            con = [(d_, p_, make_frame(n))]
        elif (t1, t2) == (GEOM_PLANE, GEOM_BOX):
            n = m1[..., :, 2]
            corners = like.new_tensor(
                [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
            )  # (8, 3)
            corner_l = corners[None] * sz2[..., None, :]  # (npair, 8, 3), or [B, npair, 8, 3]
            corner_w = x2[:, :, None, :] + (m2[:, :, None, :, :] * corner_l[..., None, :]).sum(-1)
            hs = (n[:, :, None, :] * (corner_w - x1[:, :, None, :])).sum(-1)  # [B, npair, 8]
            negd, sel = torch.topk(-hs, 4, dim=-1)
            d4 = -negd
            c4 = torch.gather(corner_w, 2, sel[..., None].expand(bsz, npair, 4, 3))
            p4 = c4 - 0.5 * d4[..., None] * n[:, :, None, :]
            fr = make_frame(n)
            con = [(d4[..., i], p4[:, :, i], fr) for i in range(4)]
        elif (t1, t2) == (GEOM_SPHERE, GEOM_SPHERE):
            d12 = x2 - x1
            ln = torch.clamp(_norm(d12), min=1e-12)
            n = d12 / ln[..., None]
            dist = ln - (sz1[..., 0] + sz2[..., 0])
            pos = x1 + n * (sz1[..., 0] + 0.5 * dist)[..., None]
            con = [(dist, pos, make_frame(n))]
        elif (t1, t2) == (GEOM_SPHERE, GEOM_CAPSULE):
            axis = m2[..., :, 2]
            hl = sz2[..., 1]
            t = torch.minimum(torch.maximum(dot(x1 - x2, axis), -hl), hl)
            d12 = x2 + axis * t[..., None] - x1
            ln = torch.clamp(_norm(d12), min=1e-12)
            n = d12 / ln[..., None]
            dist = ln - (sz1[..., 0] + sz2[..., 0])
            pos = x1 + n * (sz1[..., 0] + 0.5 * dist)[..., None]
            con = [(dist, pos, make_frame(n))]
        elif (t1, t2) == (GEOM_CAPSULE, GEOM_CAPSULE):
            a_ax, b_ax = m1[..., :, 2], m2[..., :, 2]
            a_hl, b_hl = sz1[..., 1], sz2[..., 1]
            d0 = x2 - x1
            a_dot_b = dot(a_ax, b_ax)
            a_dot_d = dot(a_ax, d0)
            b_dot_d = dot(b_ax, d0)
            denom = torch.clamp(1.0 - a_dot_b**2, min=1e-9)

            def clip(x, h):
                return torch.minimum(torch.maximum(x, -h), h)

            ta = clip((a_dot_d - a_dot_b * b_dot_d) / denom, a_hl)
            tb = clip(ta * a_dot_b - b_dot_d, b_hl)
            ta = clip(tb * a_dot_b + a_dot_d, a_hl)
            pa = x1 + a_ax * ta[..., None]
            pb = x2 + b_ax * tb[..., None]
            d12 = pb - pa
            ln = torch.clamp(_norm(d12), min=1e-12)
            n = d12 / ln[..., None]
            dist = ln - (sz1[..., 0] + sz2[..., 0])
            pos = pa + n * (sz1[..., 0] + 0.5 * dist)[..., None]
            con = [(dist, pos, make_frame(n))]
        else:
            raise NotImplementedError((t1, t2))

        for d_, p_, fr_ in con:
            dists.append(d_)
            poss.append(p_)
            frames.append(fr_)
            fris.append(fri)
            refs.append(ref)
            imps.append(imp)
            margins.append(inc)

    if not dists:
        return data, Contact(
            dist=like.new_zeros((bsz, 0)),
            pos=like.new_zeros((bsz, 0, 3)),
            frame=like.new_zeros((bsz, 0, 3, 3)),
            friction=like.new_zeros((0, 5)),
            solref=like.new_zeros((0, 2)),
            solimp=like.new_zeros((0, 5)),
            includemargin=like.new_zeros((0,)),
        )
    contact = Contact(
        dist=torch.cat(dists, dim=1),
        pos=torch.cat(poss, dim=1),
        frame=torch.cat(frames, dim=1),
        friction=torch.cat(fris, dim=-2),
        solref=torch.cat(refs, dim=-2),
        solimp=torch.cat(imps, dim=-2),
        includemargin=torch.cat(margins, dim=-1),
    )
    data = data.replace(
        contact_dist=contact.dist, contact_pos=contact.pos, contact_frame=contact.frame
    )
    return data, contact


def contact_bodies(plan: PhysicsPlan):
    """Static (geom1, geom2, body1, body2) per contact slot, in the emission
    order of `collide` (per group: slot 0 of every pair, then slot 1, ...)."""
    g1_out, g2_out = [], []
    for t1, t2, g1, g2 in plan.pair_groups:
        for _ in range(plan.ncon_per_pair_type[(t1, t2)]):
            g1_out.append(g1)
            g2_out.append(g2)
    geom1 = np.concatenate(g1_out) if g1_out else np.zeros(0, np.int64)
    geom2 = np.concatenate(g2_out) if g2_out else np.zeros(0, np.int64)
    body1 = plan.geom_bodyid[geom1] if len(geom1) else geom1
    body2 = plan.geom_bodyid[geom2] if len(geom2) else geom2
    return geom1, geom2, body1, body2
