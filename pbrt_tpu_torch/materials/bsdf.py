"""Device-side BSDF engine: closed-set lobes over wavefront hit batches.

Port of pbrt_tpu/materials/bsdf.py. The reference's virtual BxDF stack
(core/reflection.{h,cpp}: BSDF :153, Lambertian :355, OrenNayar :369,
SpecularReflection :306, SpecularTransmission :328, Microfacet with
Blinn/Anisotropic :399-461, FresnelBlend :463) becomes a fixed set of
canonical lobes evaluated masked over the batch:

  1. diffuse reflection  (Lambertian / Oren-Nayar by sigma)
  2. diffuse transmission (translucent)
  3. glossy microfacet   (Blinn or Anisotropic; dielectric/conductor F),
     FresnelBlend for substrate, glossy transmission for translucent
  4. specular reflection (dielectric / conductor / no-op F)
  5. specular transmission (dielectric, with the student Cauchy
     dispersion: eta(lambda) = A + B/lambda_um^2, B = 0.52345 (eta-1)/Vn,
     A = eta - B/0.34522792 — reference core/reflection.cpp:155-162)

A measured BRDF replaces the diffuse value on its lanes; a mix material
carries the second constituent's full lobe set (Lobes.mix2) and the
spectral amount, and every entry point blends the two. Each material
kind maps onto these lobes in `material_lobes`. Sampling picks a lobe by
luminance, then returns the combined f, pdf and flags (pbrt's Sample_f
contract).
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

# fresnel kinds for the glossy/specular slots
F_NONE, F_DIELECTRIC, F_CONDUCTOR = 0, 1, 2


class BsdfParams(NamedTuple):
    """Per-hit material record, [H] leading axis. Slot reuse per kind is
    documented in material_lobes."""

    kind: torch.Tensor      # [H] int64 (materials.registry.KIND_ID)
    kd: torch.Tensor        # [H, S]
    ks: torch.Tensor        # [H, S]
    kr: torch.Tensor        # [H, S]
    kt: torch.Tensor        # [H, S]
    opacity: torch.Tensor   # [H, S]
    rough_u: torch.Tensor   # [H]
    rough_v: torch.Tensor   # [H]
    eta: torch.Tensor       # [H]
    vn: torch.Tensor        # [H] Abbe number (glass dispersion)
    sigma: torch.Tensor     # [H] oren-nayar sigma (degrees)
    meas_id: torch.Tensor = None       # [H] int64 measured-table index (-1 none)
    meas_tables: torch.Tensor = None   # [T,TH,TD,PD,3] shared half-angle tables
    mix2: "BsdfParams" = None          # second constituent (mix material)
    mix_amt: torch.Tensor = None       # [H, S] spectral blend amount

    @staticmethod
    def none(h, device):
        z = torch.zeros((h, S), device=device)
        zf = torch.zeros((h,), device=device)
        return BsdfParams(torch.zeros((h,), dtype=torch.int64, device=device),
                          z, z, z, z, z, zf, zf, torch.ones((h,), device=device), zf, zf)


class Lobes(NamedTuple):
    """The canonical lobe set derived from BsdfParams."""

    diff_r: torch.Tensor        # [H, S]
    diff_t: torch.Tensor        # [H, S]
    sigma: torch.Tensor         # [H]
    gloss: torch.Tensor         # [H, S] glossy coefficient
    gloss_t: torch.Tensor       # [H, S] translucent glossy transmission
    gloss_f_kind: torch.Tensor  # [H] fresnel kind for glossy
    gloss_eta: torch.Tensor     # [H] dielectric ior for glossy fresnel
    gloss_eta_s: torch.Tensor   # [H, S] conductor eta
    gloss_k_s: torch.Tensor     # [H, S] conductor k
    blinn_e: torch.Tensor       # [H] blinn exponent
    aniso: torch.Tensor         # [H] bool: use the anisotropic distribution
    aniso_ex: torch.Tensor      # [H]
    aniso_ey: torch.Tensor      # [H]
    fb: torch.Tensor            # [H] bool: FresnelBlend (substrate)
    spec_r: torch.Tensor        # [H, S]
    spec_r_f_kind: torch.Tensor  # [H]
    spec_r_eta_s: torch.Tensor  # [H, S] conductor eta for specular reflection
    spec_r_k_s: torch.Tensor    # [H, S]
    spec_t: torch.Tensor        # [H, S]
    eta: torch.Tensor           # [H]
    vn: torch.Tensor            # [H]
    meas_id: torch.Tensor = None      # [H] (-1 none)
    meas_tables: torch.Tensor = None  # [T,TH,TD,PD,3]
    # mix material (reference materials/mixmat.cpp:62: BOTH constituent
    # BSDFs evaluated, scaled by amount / 1-amount): the second
    # constituent's lobe set + the spectral amount on the first
    mix2: "Lobes" = None
    mix_amt: torch.Tensor = None      # [H, S]


def _zero(t):
    return torch.zeros((), device=t.device)


def fresnel_dielectric(cos_i, eta_i, eta_t):
    """Unpolarized dielectric Fresnel; cos_i may be signed (entering if >0).
    (reference core/reflection.cpp FrDiel)"""
    entering = cos_i > 0.0
    # a Python number enters torch.where as a scalar: no copy to the card
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


def fresnel_conductor(cos_i, eta, k):
    """Conductor Fresnel (spectral eta/k [.., S]; cos_i [..]) -> [.., S]."""
    ci = torch.abs(cos_i)[..., None]
    tmp = (eta * eta + k * k) * ci * ci
    r_par2 = (tmp - 2.0 * eta * ci + 1.0) / torch.clamp(tmp + 2.0 * eta * ci + 1.0, min=1e-12)
    tmp_f = eta * eta + k * k
    r_per2 = (tmp_f - 2.0 * eta * ci + ci * ci) / torch.clamp(
        tmp_f + 2.0 * eta * ci + ci * ci, min=1e-12)
    return 0.5 * (r_par2 + r_per2)


def fresnel_approx_eta(r):
    """Reflectance -> synthetic eta (reference core/reflection.h FresnelApproxEta)."""
    r = torch.clamp(r, 0.0, 0.999)
    return (1.0 + torch.sqrt(r)) / (1.0 - torch.sqrt(r))


def fresnel_approx_k(r):
    r = torch.clamp(r, 0.0, 0.999)
    return 2.0 * torch.sqrt(r / (1.0 - r))


def cauchy_eta(eta, vn, lam_nm):
    """Student dispersion fit (reference core/reflection.cpp:155-162);
    lam_nm in nanometers, converted to micrometers."""
    b = 0.52345 * (eta - 1.0) / torch.clamp(vn, min=1e-6)
    a = eta - b / 0.34522792
    lam_um = lam_nm * 1e-3
    return a + b / torch.clamp(lam_um * lam_um, min=1e-12)


def material_lobes(p: BsdfParams) -> Lobes:
    """Expand the per-hit material record into canonical lobes (masked).
    Mix materials carry a second BsdfParams (p.mix2) + spectral amount:
    both constituents expand to full lobe sets, blended by every bsdf_*
    entry point below."""
    lb = _material_lobes_one(p)
    if p.mix2 is not None:
        lb = lb._replace(mix2=_material_lobes_one(p.mix2), mix_amt=p.mix_amt)
    return lb


def _material_lobes_one(p: BsdfParams) -> Lobes:
    k = p.kind
    h = k.shape[0]
    dev = k.device
    zero = torch.zeros((), device=dev)

    def is_(*names):
        m = k == KIND_ID[names[0]]
        for n in names[1:]:
            m = m | (k == KIND_ID[n])
        return m[:, None]

    def is_f(*names):
        return is_(*names)[:, 0]

    op = torch.where(is_("uber"), p.opacity, torch.ones((), device=dev))

    diff_r = (
        torch.where(is_("matte", "measured"), p.kd, zero)
        + torch.where(is_("plastic"), p.kd, zero)
        + torch.where(is_("translucent"), p.kd * p.kr, zero)   # kr slot = reflect
        + torch.where(is_("uber"), p.kd * op, zero)
        # substrate: Kd lives in the diff slot for the FresnelBlend
        # (consumed by _fb_f; the plain lambertian path zeroes fb lanes)
        + torch.where(is_("substrate"), p.kd, zero)
    )
    diff_t = torch.where(is_("translucent"), p.kd * p.kt, zero)  # kt slot = transmit

    gloss = (
        torch.where(is_("plastic"), p.ks, zero)
        + torch.where(is_("translucent"), p.ks * p.kr, zero)
        + torch.where(is_("uber"), p.ks * op, zero)
        + torch.where(is_("metal", "shinymetal"), torch.ones((h, S), device=dev), zero)
        + torch.where(is_("substrate"), p.ks, zero)
    )
    gloss_t = torch.where(is_("translucent"), p.ks * p.kt, zero)

    gloss_f_kind = torch.where(
        is_f("metal", "shinymetal"), F_CONDUCTOR,
        torch.where(is_f("plastic", "translucent", "uber"), F_DIELECTRIC, F_NONE))
    gloss_eta = torch.where(is_f("plastic", "translucent"),
                            torch.full((), 1.5, device=dev), p.eta)
    # metal: the kd slot holds the spectral eta, the ks slot k
    gloss_eta_s = torch.where(is_("metal"), p.kd, fresnel_approx_eta(p.ks))
    gloss_k_s = torch.where(is_("metal"), p.ks, fresnel_approx_k(p.ks))

    blinn_e = 1.0 / torch.clamp(p.rough_u, min=1e-4)
    aniso = is_f("substrate") & (p.rough_u != p.rough_v)
    aniso_ex = 1.0 / torch.clamp(p.rough_u, min=1e-4)
    aniso_ey = 1.0 / torch.clamp(p.rough_v, min=1e-4)
    fb = is_f("substrate")

    spec_r = (
        torch.where(is_("glass", "mirror"), p.kr, zero)
        + torch.where(is_("uber"), p.kr * op, zero)
        + torch.where(is_("shinymetal"), p.kr, zero)
        + torch.where(is_("subsurface", "kdsubsurface"), p.kr, zero)
    )
    spec_r_f_kind = torch.where(is_f("mirror"), F_NONE,
                                torch.where(is_f("shinymetal"), F_CONDUCTOR, F_DIELECTRIC))
    spec_r_eta_s = fresnel_approx_eta(p.kr)
    spec_r_k_s = fresnel_approx_k(p.kr)

    # uber: transmission through (1-opacity) is a pass-through specular
    # transmission (reference materials/uber.cpp opacity logic)
    passthrough = torch.where(is_("uber"), 1.0 - p.opacity, zero)
    spec_t = (torch.where(is_("glass"), p.kt, zero) + torch.where(is_("uber"), p.kt * op, zero)
              + passthrough)

    return Lobes(
        diff_r=diff_r, diff_t=diff_t, sigma=p.sigma,
        gloss=gloss, gloss_t=gloss_t, gloss_f_kind=gloss_f_kind,
        gloss_eta=gloss_eta, gloss_eta_s=gloss_eta_s, gloss_k_s=gloss_k_s,
        blinn_e=blinn_e, aniso=aniso, aniso_ex=aniso_ex, aniso_ey=aniso_ey,
        fb=fb, spec_r=spec_r, spec_r_f_kind=spec_r_f_kind,
        spec_r_eta_s=spec_r_eta_s, spec_r_k_s=spec_r_k_s,
        spec_t=spec_t, eta=p.eta, vn=p.vn,
        meas_id=p.meas_id, meas_tables=p.meas_tables,
    )


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


def _flip_z(v):
    return torch.stack([v[..., 0], v[..., 1], -v[..., 2]], -1)


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
    maxcos = torch.where((sinti > 1e-4) & (sinto > 1e-4), torch.clamp(dcos, min=0.0), _zero(wo))
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


def _aniso_d(wh, ex, ey):
    cth = _abs_cos_theta(wh)
    d = 1.0 - cth * cth
    safe_d = torch.clamp(d, min=1e-7)
    expo = (ex * wh[..., 0] * wh[..., 0] + ey * wh[..., 1] * wh[..., 1]) / safe_d
    val = torch.sqrt((ex + 2.0) * (ey + 2.0)) * (0.5 * INV_PI) * torch.pow(
        torch.clamp(cth, min=1e-7), expo)
    return torch.where(d <= 1e-7, _zero(wh), val)


def _microfacet_g(wo, wi, wh):
    ndoth = _abs_cos_theta(wh)
    ndoto = _abs_cos_theta(wo)
    ndoti = _abs_cos_theta(wi)
    odoth = torch.clamp(torch.abs(dot(wo, wh)), min=1e-7)
    return torch.clamp(torch.minimum(2.0 * ndoth * ndoto / odoth,
                                     2.0 * ndoth * ndoti / odoth), max=1.0)


def _glossy_f(lb: Lobes, gloss, wo, wi):
    """Torrance-Sparrow microfacet (reflection only) with coefficient
    `gloss` [H, S]."""
    cto, cti = _abs_cos_theta(wo), _abs_cos_theta(wi)
    wh = wo + wi
    wh_len = torch.sqrt(torch.sum(wh * wh, -1))
    ok = (wh_len > 1e-7) & (cto > 1e-7) & (cti > 1e-7) & _same_hemisphere(wo, wi)
    wh = wh / torch.clamp(wh_len, min=1e-7)[..., None]
    d_blinn = _blinn_d(_abs_cos_theta(wh), lb.blinn_e)
    d_aniso = _aniso_d(wh, lb.aniso_ex, lb.aniso_ey)
    d = torch.where(lb.aniso, d_aniso, d_blinn)
    g = _microfacet_g(wo, wi, wh)
    cos_ih = dot(wi, wh)
    f_diel = fresnel_dielectric(cos_ih, 1.0, lb.gloss_eta)[..., None]
    f_cond = fresnel_conductor(cos_ih, lb.gloss_eta_s, lb.gloss_k_s)
    fr = torch.where((lb.gloss_f_kind == F_CONDUCTOR)[..., None], f_cond,
                     torch.where((lb.gloss_f_kind == F_DIELECTRIC)[..., None], f_diel,
                                 torch.ones((), device=wo.device)))
    denom = torch.clamp(4.0 * cto * cti, min=1e-7)
    f = gloss * (d * g / denom)[..., None] * fr
    return torch.where(ok[..., None], f, _zero(wo))


def _glossy_pdf(lb: Lobes, wo, wi):
    wh = normalize(wo + wi)
    cos_h = _abs_cos_theta(wh)
    dot_oh = torch.clamp(torch.abs(dot(wo, wh)), min=1e-7)
    pdf_blinn = ((lb.blinn_e + 1.0) * torch.pow(torch.clamp(cos_h, min=1e-7), lb.blinn_e)) / (
        2.0 * math.pi * 4.0 * dot_oh)
    # aniso: wh is sampled proportional to D * cos
    d_aniso = _aniso_d(wh, lb.aniso_ex, lb.aniso_ey)
    pdf_aniso = (d_aniso * cos_h / torch.clamp(4.0 * dot_oh, min=1e-7)
                 / torch.clamp(cos_h, min=1e-7))
    pdf = torch.where(lb.aniso, pdf_aniso, pdf_blinn)
    return torch.where(_same_hemisphere(wo, wi), pdf, _zero(wo))


def _fb_f(lb: Lobes, wo, wi):
    """FresnelBlend (Ashikhmin-Shirley, reference reflection.cpp:463)."""
    cto, cti = _abs_cos_theta(wo), _abs_cos_theta(wi)
    ok = (cto > 1e-7) & (cti > 1e-7) & _same_hemisphere(wo, wi)
    rd, rs = lb.diff_r, lb.gloss  # substrate: Kd in the diff slot, Ks in gloss
    diffuse = (28.0 / (23.0 * math.pi)) * rd * (1.0 - rs) * (
        (1.0 - torch.pow(1.0 - 0.5 * cti, 5.0)) * (1.0 - torch.pow(1.0 - 0.5 * cto, 5.0))
    )[..., None]
    wh = wo + wi
    wh_len = torch.sqrt(torch.sum(wh * wh, -1))
    wh = wh / torch.clamp(wh_len, min=1e-7)[..., None]
    d_blinn = _blinn_d(_abs_cos_theta(wh), lb.blinn_e)
    d_aniso = _aniso_d(wh, lb.aniso_ex, lb.aniso_ey)
    d = torch.where(lb.aniso, d_aniso, d_blinn)
    dot_ih = torch.abs(dot(wi, wh))
    schlick = rs + torch.pow(1.0 - dot_ih, 5.0)[..., None] * (1.0 - rs)
    specular = (d / torch.clamp(4.0 * dot_ih * torch.maximum(cti, cto), min=1e-7))[..., None] \
        * schlick
    return torch.where((ok & (wh_len > 1e-7))[..., None], diffuse + specular, _zero(wo))


# ---------------------------------------------------------------------------
# Public BSDF interface over world-space directions

def _active_weights(lb: Lobes):
    """Per-lobe scalar weights for lobe selection (luminance)."""
    w_diff = spec.y(lb.diff_r) + spec.y(lb.diff_t)
    w_gloss = spec.y(lb.gloss) + spec.y(lb.gloss_t)
    w_spec_r = spec.y(lb.spec_r)
    w_spec_t = spec.y(lb.spec_t)
    # substrate folds its diffuse into the fb lobe (inside _fb_f): no
    # double counting
    w_diff = torch.where(lb.fb, _zero(w_diff), w_diff)
    return w_diff, w_gloss, w_spec_r, w_spec_t


def bsdf_f(lb: Lobes, frame: Frame, wo_w, wi_w):
    """Non-specular f(wo, wi), world-space directions. [H, S]. Mix lanes
    evaluate BOTH constituents and blend spectrally by the amount
    (reference mixmat.cpp:62)."""
    f = _bsdf_f_one(lb, frame, wo_w, wi_w)
    if lb.mix2 is not None:
        f2 = _bsdf_f_one(lb.mix2, frame, wo_w, wi_w)
        f = lb.mix_amt * f + (1.0 - lb.mix_amt) * f2
    return f


def _bsdf_f_one(lb: Lobes, frame: Frame, wo_w, wi_w):
    wo = frame.to_local(wo_w)
    wi = frame.to_local(wi_w)
    zero = _zero(wo)
    # the geometric normal classifies reflect vs transmit (pbrt BSDF::f)
    reflect = dot(wi_w, frame.ng) * dot(wo_w, frame.ng) > 0.0
    same = _same_hemisphere(wo, wi)
    dr = _diffuse_f(torch.where(lb.fb[..., None], zero, lb.diff_r), lb.sigma, wo, wi)
    # the measured half-angle table replaces the lambertian value on
    # measured lanes (sampled like diffuse: reference core/reflection.cpp
    # RegularHalfangleBRDF::f has no Sample_f override)
    if lb.meas_tables is not None:
        from pbrt_tpu_torch.materials.measured import eval_measured

        f_meas = eval_measured(lb.meas_tables, lb.meas_id, wo, wi)
        dr = torch.where((lb.meas_id >= 0)[..., None], f_meas, dr)
    dt = _diffuse_f(lb.diff_t, lb.sigma, wo, wi)
    f = torch.where((reflect & same)[..., None], dr, zero)
    f = f + torch.where((~reflect)[..., None], dt, zero)
    # glossy reflection
    gf = _glossy_f(lb, torch.where(lb.fb[..., None], zero, lb.gloss), wo, wi)
    f = f + torch.where(reflect[..., None], gf, zero)
    # translucent glossy transmission: evaluated with wi flipped
    gt = _glossy_f(lb, lb.gloss_t, wo, _flip_z(wi))
    f = f + torch.where((~reflect)[..., None], gt, zero)
    # fresnel blend
    fbv = _fb_f(lb, wo, wi)
    return f + torch.where((lb.fb & reflect)[..., None], fbv, zero)


def bsdf_pdf(lb: Lobes, frame: Frame, wo_w, wi_w):
    """pdf of sampling wi given wo over the non-specular lobes, weighted
    by the same lobe-selection probabilities as bsdf_sample. Mix lanes:
    the one-sample mixture pdf, children weighted by amount luminance."""
    p = _bsdf_pdf_one(lb, frame, wo_w, wi_w)
    if lb.mix2 is not None:
        p2 = _bsdf_pdf_one(lb.mix2, frame, wo_w, wi_w)
        ya = torch.clamp(spec.y(lb.mix_amt), 0.0, 1.0)
        p = ya * p + (1.0 - ya) * p2
    return p


def _bsdf_pdf_one(lb: Lobes, frame: Frame, wo_w, wi_w):
    wo = frame.to_local(wo_w)
    wi = frame.to_local(wi_w)
    zero = _zero(wo)
    w_diff, w_gloss, w_spec_r, w_spec_t = _active_weights(lb)
    w_fb = torch.where(lb.fb, spec.y(lb.diff_r) + spec.y(lb.gloss), zero)
    w_gloss = torch.where(lb.fb, zero, w_gloss)
    total = w_diff + w_gloss + w_spec_r + w_spec_t + w_fb
    same = _same_hemisphere(wo, wi)
    pdf_diff = _abs_cos_theta(wi) * INV_PI
    # the diffuse lobe splits its probability between reflection and
    # transmission by their luminance
    wdr, wdt = spec.y(lb.diff_r), spec.y(lb.diff_t)
    wd_tot = torch.clamp(wdr + wdt, min=1e-12)
    p_diff = pdf_diff * torch.where(same, wdr / wd_tot, wdt / wd_tot)
    p_gloss_r = _glossy_pdf(lb, wo, wi)
    p_gloss_t = _glossy_pdf(lb, wo, _flip_z(wi))
    wgr = spec.y(lb.gloss)
    wgt = spec.y(lb.gloss_t)
    wg_tot = torch.clamp(wgr + wgt, min=1e-12)
    p_gloss = torch.where(same, p_gloss_r * wgr / wg_tot, p_gloss_t * wgt / wg_tot)
    # fresnel blend pdf: 0.5 cos-hemisphere + 0.5 blinn
    p_fb = torch.where(same, 0.5 * (_abs_cos_theta(wi) * INV_PI) + 0.5 * p_gloss_r, zero)
    tot = torch.clamp(total, min=1e-12)
    return w_diff / tot * p_diff + w_gloss / tot * p_gloss + w_fb / tot * p_fb


class BsdfSample(NamedTuple):
    wi: torch.Tensor           # [H, 3] world
    f: torch.Tensor            # [H, S] (specular: the weight f with
                               # throughput *= f * |cos| / pdf)
    pdf: torch.Tensor          # [H]
    is_specular: torch.Tensor  # [H] bool
    did_transmit: torch.Tensor  # [H] bool (entered specular transmission)
    valid: torch.Tensor        # [H] bool


def bsdf_sample(lb: Lobes, frame: Frame, wo_w, u_lobe, u1, u2, u3=None,
                lam_nm=None, u_pick=None) -> BsdfSample:
    """Sample an outgoing direction. u_lobe/u1/u2/u3: [H] uniforms (u3
    drives sub-lobe choices; without it, a scramble of u_lobe). lam_nm:
    [H] wavelength (nm) carried by the lane for dispersion (< 0 for
    dense-spectrum lanes). u_pick: [H] uniform for the mix-constituent
    choice (without it, a scramble of u_lobe).

    Mix lanes pick a constituent with probability = amount luminance
    and sample a direction from it. For NON-specular picks the returned
    (f, pdf) are the full blend amt*f1 + (1-amt)*f2 and the mixture pdf
    ya*p1 + (1-ya)*p2, the density bsdf_pdf reports (reference
    BSDF::Sample_f over ScaledBxDFs, core/reflection.cpp:534-564).
    Specular picks keep the single-constituent form."""
    if lb.mix2 is None:
        return _bsdf_sample_one(lb, frame, wo_w, u_lobe, u1, u2, u3, lam_nm)
    ya = torch.clamp(spec.y(lb.mix_amt), 0.0, 1.0)
    if u_pick is None:
        u_pick = (u_lobe * 811.0) % 1.0
    choose1 = u_pick < ya
    lb1 = lb._replace(mix2=None, mix_amt=None)
    s1 = _bsdf_sample_one(lb1, frame, wo_w, u_lobe, u1, u2, u3, lam_nm)
    s2 = _bsdf_sample_one(lb.mix2, frame, wo_w, u_lobe, u1, u2, u3, lam_nm)

    def sel(a, b):
        m = choose1.reshape(choose1.shape + (1,) * (a.dim() - choose1.dim()))
        return torch.where(m, a, b)

    amt_c = torch.where(choose1[..., None], lb.mix_amt, 1.0 - lb.mix_amt)
    pick_p = torch.where(choose1, ya, 1.0 - ya)
    wi_sel = sel(s1.wi, s2.wi)
    is_spec = sel(s1.is_specular, s2.is_specular)
    # non-specular picks: blended f + mixture pdf at the sampled wi
    f_mix = (lb.mix_amt * _bsdf_f_one(lb1, frame, wo_w, wi_sel)
             + (1.0 - lb.mix_amt) * _bsdf_f_one(lb.mix2, frame, wo_w, wi_sel))
    p_mix = (ya * _bsdf_pdf_one(lb1, frame, wo_w, wi_sel)
             + (1.0 - ya) * _bsdf_pdf_one(lb.mix2, frame, wo_w, wi_sel))
    return BsdfSample(
        wi=wi_sel,
        f=torch.where(is_spec[..., None], amt_c * sel(s1.f, s2.f), f_mix),
        pdf=torch.where(is_spec, pick_p * sel(s1.pdf, s2.pdf), p_mix),
        is_specular=is_spec,
        did_transmit=sel(s1.did_transmit, s2.did_transmit),
        valid=sel(s1.valid, s2.valid) & (pick_p > 1e-6),
    )


def _bsdf_sample_one(lb: Lobes, frame: Frame, wo_w, u_lobe, u1, u2, u3=None,
                     lam_nm=None) -> BsdfSample:
    wo = frame.to_local(wo_w)
    h = wo.shape[0]
    dev = wo.device
    zero = torch.zeros((), device=dev)
    one = torch.ones((), device=dev)
    if lam_nm is None:
        lam_nm = torch.full((h,), -1.0, device=dev)
    if u3 is None:
        u3 = torch.clamp((u_lobe * 997.0) % 1.0, 0.0, 1.0)

    w_diff, w_gloss, w_spec_r, w_spec_t = _active_weights(lb)
    w_fb = torch.where(lb.fb, spec.y(lb.diff_r) + spec.y(lb.gloss), zero)
    w_gloss_sel = torch.where(lb.fb, zero, w_gloss)
    ws = torch.stack([w_diff, w_gloss_sel + w_fb, w_spec_r, w_spec_t], -1)
    total = torch.sum(ws, -1)
    probs = ws / torch.clamp(total[..., None], min=1e-12)
    cdf = torch.cumsum(probs, -1)
    lobe_idx = torch.clamp(torch.sum((u_lobe[..., None] > cdf).to(torch.int64), -1), 0, 3)
    pick_prob = torch.gather(probs, -1, lobe_idx[..., None])[..., 0]
    wo_below = (wo[..., 2] < 0)[..., None]

    # candidate 0: diffuse (cosine hemisphere; maybe on the transmitted side)
    wi_diff = cosine_sample_hemisphere(u1, u2)
    wdr, wdt = spec.y(lb.diff_r), spec.y(lb.diff_t)
    wd_tot = torch.clamp(wdr + wdt, min=1e-12)
    # transmit only when a diffuse-transmission lobe exists
    diff_transmit = (wdt > 1e-9) & (u3 > (wdr / wd_tot))
    wi_diff = torch.where(diff_transmit[..., None], _flip_z(wi_diff), wi_diff)
    wi_diff = torch.where(wo_below, _flip_z(wi_diff), wi_diff)

    # candidate 1: glossy (blinn / aniso / fresnelblend half-half)
    e = lb.blinn_e
    cos_h = torch.pow(torch.clamp(u1, min=1e-9), 1.0 / (e + 1.0))
    sin_h = torch.sqrt(torch.clamp(1.0 - cos_h * cos_h, min=0.0))
    phi_h = 2.0 * math.pi * u2
    # anisotropic first-quadrant sampling (reference reflection.cpp
    # Anisotropic::Sample_f), mapped to four quadrants by u2
    u2q = (u2 * 4.0) % 1.0
    quad = torch.clamp((u2 * 4.0).to(torch.int32), 0, 3)
    phi_a = torch.atan(torch.sqrt((lb.aniso_ex + 1.0) / (lb.aniso_ey + 1.0))
                       * torch.tan(math.pi * u2q * 0.5))
    phi_a = torch.where(quad == 1, math.pi - phi_a, phi_a)
    phi_a = torch.where(quad == 2, math.pi + phi_a, phi_a)
    phi_a = torch.where(quad == 3, 2.0 * math.pi - phi_a, phi_a)
    cphi, sphi = torch.cos(phi_a), torch.sin(phi_a)
    cos_ha = torch.pow(torch.clamp(u1, min=1e-9),
                       1.0 / (lb.aniso_ex * cphi * cphi + lb.aniso_ey * sphi * sphi + 1.0))
    sin_ha = torch.sqrt(torch.clamp(1.0 - cos_ha * cos_ha, min=0.0))
    wh = torch.where(
        lb.aniso[..., None],
        torch.stack([sin_ha * cphi, sin_ha * sphi, cos_ha], -1),
        torch.stack([sin_h * torch.cos(phi_h), sin_h * torch.sin(phi_h), cos_h], -1))
    wh = torch.where(wo_below, _flip_z(wh), wh)
    wi_gloss = -wo + 2.0 * dot(wo, wh)[..., None] * wh
    # fresnelblend: half the samples go diffuse
    wi_gloss = torch.where((lb.fb & (u3 < 0.5))[..., None], wi_diff, wi_gloss)

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
    f_ns = _bsdf_f_one(lb, frame, wo_w, wi_w)
    pdf_ns = _bsdf_pdf_one(lb, frame, wo_w, wi_w)

    # specular reflection weight
    cos_o = wo[..., 2]
    fr_d = fresnel_dielectric(cos_o, 1.0, eta_lane)
    fr_c = fresnel_conductor(cos_o, lb.spec_r_eta_s, lb.spec_r_k_s)
    fr_s = torch.where((lb.spec_r_f_kind == F_CONDUCTOR)[..., None], fr_c,
                       torch.where((lb.spec_r_f_kind == F_DIELECTRIC)[..., None],
                                   fr_d[..., None], one))
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


def has_transmissive(lb: Lobes):
    """Lane has any transmissive lobe (the dispersion trigger of
    reference photonshooter.cpp:141-145)."""
    h = ((torch.sum(lb.spec_t, -1) > 0) | (torch.sum(lb.diff_t, -1) > 0)
         | (torch.sum(lb.gloss_t, -1) > 0))
    if lb.mix2 is not None:
        h = h | has_transmissive(lb.mix2)
    return h


def has_specular(lb: Lobes):
    h = (torch.sum(lb.spec_r, -1) > 0) | (torch.sum(lb.spec_t, -1) > 0)
    if lb.mix2 is not None:
        h = h | has_specular(lb.mix2)
    return h


def has_non_specular(lb: Lobes):
    h = ((torch.sum(lb.diff_r, -1) > 0) | (torch.sum(lb.diff_t, -1) > 0)
         | (torch.sum(lb.gloss, -1) > 0) | (torch.sum(lb.gloss_t, -1) > 0))
    if lb.mix2 is not None:
        h = h | has_non_specular(lb.mix2)
    return h


def rho_proxies(lb: Lobes):
    """(rho_r, rho_t) reflectance proxies of the density estimates
    (photon-map LPhoton rho(wo) * INV_PI, reference photonmap.cpp:88-103),
    mix-aware."""
    rr = lb.diff_r + lb.gloss
    rt = lb.diff_t + lb.gloss_t
    if lb.mix2 is not None:
        rr2, rt2 = rho_proxies(lb.mix2)
        rr = lb.mix_amt * rr + (1.0 - lb.mix_amt) * rr2
        rt = lb.mix_amt * rt + (1.0 - lb.mix_amt) * rt2
    return rr, rt
