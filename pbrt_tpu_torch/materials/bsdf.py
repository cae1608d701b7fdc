"""Device-side BSDF engine over wavefront hit batches.

Port of pbrt_tpu/materials/bsdf.py for the matte, plastic, mirror and
(dispersive) glass materials. Each material maps onto the reference's
canonical lobes, evaluated masked over the batch:

  1. diffuse reflection  (Lambertian / Oren-Nayar by sigma)   matte, plastic
  2. glossy microfacet   (Blinn, dielectric Fresnel)         plastic
  3. specular reflection (no-op or dielectric Fresnel)       mirror, glass
  4. specular transmission with the student Cauchy dispersion
     eta(lambda) = A + B/lambda_um^2, B = 0.52345 (eta-1)/Vn,
     A = eta - B/0.34522792 (reference core/reflection.cpp:155-162)  glass

The lobes the four kinds leave empty in the reference (diffuse and
glossy transmission, anisotropic, FresnelBlend, conductor, measured,
mix) contribute exact zeros there and are not carried. Sampling picks
a lobe by luminance, then returns the combined f, pdf and flags
(pbrt's Sample_f contract).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core.geometry import dot, normalize
from pbrt_tpu_torch.core.sampling import INV_PI, cosine_sample_hemisphere
from pbrt_tpu_torch.materials.registry import KIND_ID

S = spec.N_BINS

# fresnel kinds for the glossy/specular slots (ids as in pbrt_tpu)
F_NONE, F_DIELECTRIC = 0, 1

PORTED_KINDS = ("matte", "plastic", "mirror", "glass")


class BsdfParams(NamedTuple):
    """Per-hit material record, [H] leading axis."""

    kind: torch.Tensor      # [H] int64 (materials.registry.KIND_ID)
    kd: torch.Tensor        # [H, S]
    ks: torch.Tensor        # [H, S]
    kr: torch.Tensor        # [H, S]
    kt: torch.Tensor        # [H, S]
    rough_u: torch.Tensor   # [H]
    eta: torch.Tensor       # [H]
    vn: torch.Tensor        # [H] Abbe number (glass dispersion)
    sigma: torch.Tensor     # [H] oren-nayar sigma (degrees)

    @staticmethod
    def none(h, device):
        z = torch.zeros((h, S), device=device)
        zf = torch.zeros((h,), device=device)
        return BsdfParams(torch.zeros((h,), dtype=torch.int64, device=device),
                          z, z, z, z, zf, torch.ones((h,), device=device), zf, zf)


class Lobes(NamedTuple):
    """The lobe set derived from BsdfParams."""

    diff_r: torch.Tensor        # [H, S]
    sigma: torch.Tensor         # [H]
    gloss: torch.Tensor         # [H, S] glossy coefficient
    gloss_f_kind: torch.Tensor  # [H] fresnel kind for glossy
    gloss_eta: torch.Tensor     # [H] dielectric ior for glossy fresnel
    blinn_e: torch.Tensor       # [H] blinn exponent
    spec_r: torch.Tensor        # [H, S]
    spec_r_f_kind: torch.Tensor  # [H]
    spec_t: torch.Tensor        # [H, S]
    eta: torch.Tensor           # [H]
    vn: torch.Tensor            # [H]


def fresnel_dielectric(cos_i, eta_i, eta_t):
    """Unpolarized dielectric Fresnel; cos_i may be signed (entering if >0).
    (reference core/reflection.cpp FrDiel)"""
    entering = cos_i > 0.0
    eta_i = torch.as_tensor(eta_i, dtype=torch.float32, device=cos_i.device)
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = torch.abs(cos_i)
    sint = ei / et * torch.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    tir = sint >= 1.0
    cost = torch.sqrt(torch.clamp(1.0 - sint * sint, min=0.0))
    r_par = (et * ci - ei * cost) / torch.clamp(et * ci + ei * cost, min=1e-12)
    r_per = (ei * ci - et * cost) / torch.clamp(ei * ci + et * cost, min=1e-12)
    fr = 0.5 * (r_par * r_par + r_per * r_per)
    return torch.where(tir, torch.ones((), device=cos_i.device), fr)


def cauchy_eta(eta, vn, lam_nm):
    """Student dispersion fit (reference core/reflection.cpp:155-162);
    lam_nm in nanometers, converted to micrometers."""
    b = 0.52345 * (eta - 1.0) / torch.clamp(vn, min=1e-6)
    a = eta - b / 0.34522792
    lam_um = lam_nm * 1e-3
    return a + b / torch.clamp(lam_um * lam_um, min=1e-12)


def material_lobes(p: BsdfParams) -> Lobes:
    """Expand the per-hit material record into lobes (masked)."""
    k = p.kind
    zero = torch.zeros((), device=k.device)

    def is_(name):
        return (k == KIND_ID[name])[:, None]

    def is_f(name):
        return k == KIND_ID[name]

    diff_r = torch.where(is_("matte"), p.kd, zero) + torch.where(is_("plastic"), p.kd, zero)
    gloss = torch.where(is_("plastic"), p.ks, zero)
    gloss_f_kind = torch.where(is_f("plastic"), F_DIELECTRIC, F_NONE)
    gloss_eta = torch.where(is_f("plastic"), torch.full((), 1.5, device=k.device), p.eta)
    blinn_e = 1.0 / torch.clamp(p.rough_u, min=1e-4)
    spec_r = torch.where(is_("glass") | is_("mirror"), p.kr, zero)
    spec_r_f_kind = torch.where(is_f("mirror"), F_NONE, F_DIELECTRIC)
    spec_t = torch.where(is_("glass"), p.kt, zero)
    return Lobes(diff_r=diff_r, sigma=p.sigma, gloss=gloss, gloss_f_kind=gloss_f_kind,
                 gloss_eta=gloss_eta, blinn_e=blinn_e, spec_r=spec_r,
                 spec_r_f_kind=spec_r_f_kind, spec_t=spec_t, eta=p.eta, vn=p.vn)


# ---------------------------------------------------------------------------
# Shading frame

class Frame(NamedTuple):
    """Orthonormal shading frame: ss/ts tangent/bitangent, ns shading
    normal, ng geometric normal (reference core/reflection.h:153 BSDF)."""

    ss: torch.Tensor
    ts: torch.Tensor
    ns: torch.Tensor
    ng: torch.Tensor

    def to_local(self, v):
        return torch.stack([dot(v, self.ss), dot(v, self.ts), dot(v, self.ns)], -1)

    def to_world(self, v):
        return v[..., 0:1] * self.ss + v[..., 1:2] * self.ts + v[..., 2:3] * self.ns


def _abs_cos_theta(w):
    return torch.abs(w[..., 2])


def _sin_theta2(w):
    return torch.clamp(1.0 - w[..., 2] * w[..., 2], min=0.0)


def _same_hemisphere(w, wp):
    return w[..., 2] * wp[..., 2] > 0.0


# ---------------------------------------------------------------------------
# Lobe evaluation (local frame)

def _diffuse_f(coeff, sigma, wo, wi):
    """Lambertian or Oren-Nayar by sigma (reference reflection.cpp:369)."""
    s = sigma * (math.pi / 180.0)
    s2 = s * s
    a = 1.0 - s2 / (2.0 * (s2 + 0.33))
    b = 0.45 * s2 / (s2 + 0.09)
    sinto2, sinti2 = _sin_theta2(wo), _sin_theta2(wi)
    sinto, sinti = torch.sqrt(sinto2), torch.sqrt(sinti2)
    denom = torch.clamp(sinti * sinto, min=1e-7)
    dcos = torch.clamp((wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1]) / denom, -1.0, 1.0)
    zero = torch.zeros((), device=wo.device)
    maxcos = torch.where((sinti > 1e-4) & (sinto > 1e-4), torch.clamp(dcos, min=0.0), zero)
    acto, acti = _abs_cos_theta(wo), _abs_cos_theta(wi)
    big = torch.maximum(acto, acti)
    small = torch.minimum(acto, acti)
    sinalpha = torch.sqrt(torch.clamp(1.0 - big * big, min=0.0))
    tanbeta = torch.sqrt(torch.clamp(1.0 - small * small, min=0.0)) / torch.clamp(small, min=1e-7)
    on = a + b * maxcos * sinalpha * tanbeta
    factor = torch.where(sigma <= 0.0, torch.ones((), device=wo.device), on)
    return coeff * (INV_PI * factor)[..., None]


def _blinn_d(cos_h, e):
    return (e + 2.0) * (0.5 * INV_PI) * torch.pow(torch.clamp(cos_h, min=1e-7), e)


def _microfacet_g(wo, wi, wh):
    ndoth = _abs_cos_theta(wh)
    ndoto = _abs_cos_theta(wo)
    ndoti = _abs_cos_theta(wi)
    odoth = torch.clamp(torch.abs(dot(wo, wh)), min=1e-7)
    return torch.clamp(torch.minimum(2.0 * ndoth * ndoto / odoth,
                                     2.0 * ndoth * ndoti / odoth), max=1.0)


def _glossy_f(lb: Lobes, wo, wi):
    """Torrance-Sparrow microfacet (reflection only)."""
    cto, cti = _abs_cos_theta(wo), _abs_cos_theta(wi)
    wh = wo + wi
    wh_len = torch.sqrt(torch.sum(wh * wh, -1))
    ok = (wh_len > 1e-7) & (cto > 1e-7) & (cti > 1e-7) & _same_hemisphere(wo, wi)
    wh = wh / torch.clamp(wh_len, min=1e-7)[..., None]
    d = _blinn_d(_abs_cos_theta(wh), lb.blinn_e)
    g = _microfacet_g(wo, wi, wh)
    cos_ih = dot(wi, wh)
    f_diel = fresnel_dielectric(cos_ih, 1.0, lb.gloss_eta)[..., None]
    fr = torch.where((lb.gloss_f_kind == F_DIELECTRIC)[..., None], f_diel,
                     torch.ones((), device=wo.device))
    denom = torch.clamp(4.0 * cto * cti, min=1e-7)
    f = lb.gloss * (d * g / denom)[..., None] * fr
    return torch.where(ok[..., None], f, torch.zeros((), device=wo.device))


def _glossy_pdf(lb: Lobes, wo, wi):
    wh = normalize(wo + wi)
    cos_h = _abs_cos_theta(wh)
    dot_oh = torch.clamp(torch.abs(dot(wo, wh)), min=1e-7)
    pdf = ((lb.blinn_e + 1.0) * torch.pow(torch.clamp(cos_h, min=1e-7), lb.blinn_e)) / (
        2.0 * math.pi * 4.0 * dot_oh)
    return torch.where(_same_hemisphere(wo, wi), pdf, torch.zeros((), device=wo.device))


# ---------------------------------------------------------------------------
# Public BSDF interface over world-space directions

def _active_weights(lb: Lobes):
    """Per-lobe scalar weights for lobe selection (luminance)."""
    return spec.y(lb.diff_r), spec.y(lb.gloss), spec.y(lb.spec_r), spec.y(lb.spec_t)


def bsdf_f(lb: Lobes, frame: Frame, wo_w, wi_w):
    """Non-specular f(wo, wi), world-space directions. [H, S]."""
    wo = frame.to_local(wo_w)
    wi = frame.to_local(wi_w)
    # the geometric normal classifies reflect vs transmit (pbrt BSDF::f)
    reflect = dot(wi_w, frame.ng) * dot(wo_w, frame.ng) > 0.0
    same = _same_hemisphere(wo, wi)
    zero = torch.zeros((), device=wo.device)
    dr = _diffuse_f(lb.diff_r, lb.sigma, wo, wi)
    f = torch.where((reflect & same)[..., None], dr, zero)
    return f + torch.where(reflect[..., None], _glossy_f(lb, wo, wi), zero)


def bsdf_pdf(lb: Lobes, frame: Frame, wo_w, wi_w):
    """pdf of sampling wi given wo over the non-specular lobes, weighted
    by the same lobe-selection probabilities as bsdf_sample."""
    wo = frame.to_local(wo_w)
    wi = frame.to_local(wi_w)
    w_diff, w_gloss, w_spec_r, w_spec_t = _active_weights(lb)
    total = w_diff + w_gloss + w_spec_r + w_spec_t
    same = _same_hemisphere(wo, wi)
    zero = torch.zeros((), device=wo.device)
    wdr = w_diff
    p_diff = _abs_cos_theta(wi) * INV_PI * torch.where(
        same, wdr / torch.clamp(wdr, min=1e-12), zero)
    wgr = w_gloss
    p_gloss = torch.where(same, _glossy_pdf(lb, wo, wi) * wgr / torch.clamp(wgr, min=1e-12),
                          zero)
    tot = torch.clamp(total, min=1e-12)
    return w_diff / tot * p_diff + w_gloss / tot * p_gloss


class BsdfSample(NamedTuple):
    wi: torch.Tensor           # [H, 3] world
    f: torch.Tensor            # [H, S] (specular: the weight f with
                               # throughput *= f * |cos| / pdf)
    pdf: torch.Tensor          # [H]
    is_specular: torch.Tensor  # [H] bool
    did_transmit: torch.Tensor  # [H] bool (entered specular transmission)
    valid: torch.Tensor        # [H] bool


def _flip_z(v):
    return torch.stack([v[..., 0], v[..., 1], -v[..., 2]], -1)


def bsdf_sample(lb: Lobes, frame: Frame, wo_w, u_lobe, u1, u2, lam_nm=None) -> BsdfSample:
    """Sample an outgoing direction. u_lobe/u1/u2: [H] uniforms; lam_nm:
    [H] wavelength (nm) carried by the lane for dispersion (< 0 for
    dense-spectrum lanes). The reference's u3 and u_pick drive sub-lobe
    and mix choices of kinds not yet ported and are left out."""
    wo = frame.to_local(wo_w)
    h = wo.shape[0]
    dev = wo.device
    zero = torch.zeros((), device=dev)
    one = torch.ones((), device=dev)
    if lam_nm is None:
        lam_nm = torch.full((h,), -1.0, device=dev)

    w_diff, w_gloss, w_spec_r, w_spec_t = _active_weights(lb)
    ws = torch.stack([w_diff, w_gloss, w_spec_r, w_spec_t], -1)
    total = w_diff + w_gloss + w_spec_r + w_spec_t
    probs = ws / torch.clamp(total[..., None], min=1e-12)
    cdf = torch.cumsum(probs, -1)
    lobe_idx = torch.clamp(torch.sum((u_lobe[..., None] > cdf).to(torch.int64), -1), 0, 3)
    pick_prob = torch.gather(probs, -1, lobe_idx[..., None])[..., 0]

    # candidate 0: diffuse (cosine hemisphere, on wo's side)
    wi_diff = cosine_sample_hemisphere(u1, u2)
    wo_below = (wo[..., 2] < 0)[..., None]
    wi_diff = torch.where(wo_below, _flip_z(wi_diff), wi_diff)

    # candidate 1: glossy (Blinn half-vector sampling)
    e = lb.blinn_e
    cos_h = torch.pow(torch.clamp(u1, min=1e-9), 1.0 / (e + 1.0))
    sin_h = torch.sqrt(torch.clamp(1.0 - cos_h * cos_h, min=0.0))
    phi_h = 2.0 * math.pi * u2
    wh = torch.stack([sin_h * torch.cos(phi_h), sin_h * torch.sin(phi_h), cos_h], -1)
    wh = torch.where(wo_below, _flip_z(wh), wh)
    wi_gloss = -wo + 2.0 * dot(wo, wh)[..., None] * wh

    # candidate 2: specular reflection
    wi_spec_r = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)

    # candidate 3: specular transmission (with dispersion)
    eta_lane = torch.where((lb.vn > 0.0) & (lam_nm > 0.0),
                           cauchy_eta(lb.eta, lb.vn, lam_nm), lb.eta)
    entering = wo[..., 2] > 0.0
    ei = torch.where(entering, one, eta_lane)
    et = torch.where(entering, eta_lane, one)
    sini2 = _sin_theta2(wo)
    eta_ratio = ei / et
    sint2 = eta_ratio * eta_ratio * sini2
    tir = sint2 >= 1.0
    cost = torch.sqrt(torch.clamp(1.0 - sint2, min=0.0))
    cost = torch.where(entering, -cost, cost)
    wi_spec_t = torch.stack([eta_ratio * -wo[..., 0], eta_ratio * -wo[..., 1], cost], -1)

    li = lobe_idx[..., None]
    wi = torch.where(li == 0, wi_diff,
                     torch.where(li == 1, wi_gloss, torch.where(li == 2, wi_spec_r, wi_spec_t)))
    is_specular = lobe_idx >= 2
    did_transmit = (lobe_idx == 3) & ~tir
    wi_w = frame.to_world(wi)

    # non-specular: combined f and pdf over all non-specular lobes
    f_ns = bsdf_f(lb, frame, wo_w, wi_w)
    pdf_ns = bsdf_pdf(lb, frame, wo_w, wi_w)

    # specular reflection weight
    cos_o = wo[..., 2]
    fr_d = fresnel_dielectric(cos_o, 1.0, eta_lane)
    fr_s = torch.where(lb.spec_r_f_kind == F_DIELECTRIC, fr_d, one)[..., None]
    aci = torch.clamp(_abs_cos_theta(wi_spec_r), min=1e-7)
    f_spec_r = lb.spec_r * fr_s / aci[..., None]

    # specular transmission weight: (1-Fr) * T * (ei/et)^2 / |cos|
    act = torch.clamp(torch.abs(cost), min=1e-7)
    f_spec_t = lb.spec_t * ((1.0 - fr_d) * (ei * ei) / (et * et) / act)[..., None]
    f_spec_t = torch.where(tir[..., None], zero, f_spec_t)

    f = torch.where(li <= 1, f_ns, torch.where(li == 2, f_spec_r, f_spec_t))
    pdf = torch.where(lobe_idx <= 1, pdf_ns, pick_prob)
    valid = (total > 0) & (pdf > 1e-12) & ~(is_specular & (lobe_idx == 3) & tir)
    return BsdfSample(wi=wi_w, f=f, pdf=pdf, is_specular=is_specular,
                      did_transmit=did_transmit, valid=valid)


def has_non_specular(lb: Lobes):
    return (torch.sum(lb.diff_r, -1) > 0) | (torch.sum(lb.gloss, -1) > 0)
