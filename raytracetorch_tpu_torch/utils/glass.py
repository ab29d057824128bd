"""Optical-glass catalog: d-line/Abbe numbers and 3-term Sellmeier data.

Counterpart of ``raytracetorch_tpu/utils/glass.py``; the data are copied,
not imported.  Two dispersion models feed the trace
(core/static_dispatch.py::dispersive_iors):

- **Abbe/Cauchy**: ``SingletLens(..., **glass('N-BK7'))`` fills
  ``ior_glass`` and ``abbe_vd``; good to ~1e-3 over the visible.
- **Sellmeier**: ``SingletLens(..., **glass('N-BK7', model='sellmeier'))``
  fills ``ior_glass`` (the d-line index evaluated from the coefficients)
  and ``sellmeier`` (B1 B2 B3 C1 C2 C3, C in um^2); the catalog n(lambda)
  to ~1e-5 across 0.4-1.0 um.

Values are the standard published catalog coefficients (Schott datasheets
for named glasses; Malitson for fused silica and CaF2; Li and Dodge for
MgF2, sapphire and the fluorides).
"""

import math

import torch

CATALOG = {
    # name: (n_d, v_d)
    'N-BK7': (1.5168, 64.17),
    'N-K5': (1.5224, 59.48),
    'K7': (1.5111, 60.41),
    'N-ZK7': (1.5086, 61.19),
    'N-FK5': (1.4875, 70.41),
    'N-FK51A': (1.4866, 84.47),
    'N-PK52A': (1.4970, 81.61),
    'N-BAK1': (1.5725, 57.55),
    'N-BAK4': (1.5688, 55.98),
    'N-SK2': (1.6074, 56.65),
    'N-SK16': (1.6204, 60.32),
    'N-SSK5': (1.6584, 50.88),
    'N-BAF10': (1.6700, 47.11),
    'N-LAK8': (1.7130, 53.83),
    'N-LAK22': (1.6516, 55.89),
    'N-LASF9': (1.8503, 32.17),
    'N-KZFS4': (1.6134, 44.49),
    'LF5': (1.5814, 40.49),
    'N-F2': (1.6200, 36.43),
    'F2': (1.6200, 36.37),
    'SF2': (1.6476, 33.85),
    'N-SF2': (1.6477, 33.82),
    'SF5': (1.6727, 32.25),
    'SF6': (1.8052, 25.43),
    'SF10': (1.7283, 28.53),
    'SF11': (1.7847, 25.68),
    'N-SF6': (1.8052, 25.36),
    'N-SF14': (1.7618, 26.53),
    'N-SF15': (1.6989, 30.20),
    'N-SF57': (1.8467, 23.78),
    'FUSED-SILICA': (1.4585, 67.82),
    'CAF2': (1.4338, 95.31),
    'BAF2': (1.4744, 81.85),
    'MGF2': (1.3777, 106.22),
    'SAPPHIRE': (1.7682, 72.31),
}

# name: (B1, B2, B3, C1, C2, C3) with C in um^2 —
# n^2(lambda) = 1 + sum_i Bi lambda^2 / (lambda^2 - Ci)
SELLMEIER = {
    'N-BK7': (1.03961212, 0.231792344, 1.01046945,
              0.00600069867, 0.0200179144, 103.560653),
    'N-K5': (1.08511833, 0.199562005, 0.930511663,
             0.00661099503, 0.024110866, 111.982777),
    'K7': (1.1273555, 0.124412303, 0.827100531,
           0.00720341707, 0.0269835916, 100.384588),
    'N-ZK7': (1.07715032, 0.168079109, 0.851889892,
              0.00676601657, 0.0230642817, 89.0498778),
    'N-FK5': (0.844309338, 0.344147824, 0.910790213,
              0.00475111955, 0.0149814849, 97.8601465),
    'N-FK51A': (0.971247817, 0.216901417, 0.904651666,
                0.00472301995, 0.0153575612, 168.68133),
    'N-PK52A': (1.029607, 0.1880506, 0.736488165,
                0.00516800155, 0.0166658798, 138.964129),
    'N-BAK1': (1.12365662, 0.309276848, 0.881511957,
               0.00644742752, 0.0222284402, 107.297751),
    'N-BAK4': (1.28834642, 0.132817724, 0.945395373,
               0.00779980626, 0.0315631177, 105.965875),
    'N-SK2': (1.28189012, 0.257738258, 0.96818604,
              0.0072719164, 0.0242823527, 110.377773),
    'N-SK16': (1.34317774, 0.241144399, 0.994317969,
               0.00704687339, 0.0229005, 92.7508526),
    'N-SSK5': (1.59222659, 0.103520774, 1.05174016,
               0.00920284626, 0.0423530072, 106.927374),
    'N-BAF10': (1.5851495, 0.143559385, 1.08521269,
                0.00926681282, 0.0424489805, 105.613573),
    'N-LAK8': (1.33183167, 0.546623206, 1.19084015,
               0.00620023871, 0.0216465439, 82.5827736),
    'N-LAK22': (1.14229781, 0.535138441, 1.04088385,
                0.00585778594, 0.0198546147, 100.834017),
    'N-LASF9': (2.00029547, 0.298926886, 1.80691843,
                0.0121426017, 0.0538736236, 156.530829),
    'N-KZFS4': (1.35055424, 0.197575506, 1.09962992,
                0.0087628207, 0.0371767201, 90.3866994),
    'LF5': (1.28035628, 0.163505973, 0.893930112,
            0.00929854416, 0.0449135769, 110.493685),
    'N-F2': (1.39757037, 0.159201403, 1.2686543,
             0.00995906143, 0.0546931752, 119.248346),
    'F2': (1.34533359, 0.209073176, 0.937357162,
           0.00997743871, 0.0470450767, 111.886764),
    'SF2': (1.40301821, 0.231767504, 0.939056586,
            0.0105795466, 0.0493226978, 112.405955),
    'N-SF2': (1.47343127, 0.163681849, 1.36920899,
              0.0109019098, 0.0585683687, 127.404933),
    'SF5': (1.52481889, 0.187085527, 1.42729015,
            0.011254756, 0.0588995392, 129.141675),
    'SF6': (1.72448482, 0.390104889, 1.04572858,
            0.0134871947, 0.0569318095, 118.557185),
    'SF10': (1.62153902, 0.256287842, 1.64447552,
             0.0122241457, 0.0595736775, 147.468793),
    'SF11': (1.73759695, 0.313747346, 1.89878101,
             0.013188707, 0.0623068142, 155.23629),
    'N-SF6': (1.77931763, 0.338149866, 2.08734474,
              0.0133714182, 0.0617533621, 174.01759),
    'N-SF14': (1.69022361, 0.288870052, 1.7045187,
               0.0130512113, 0.061369188, 149.517689),
    'N-SF15': (1.57055634, 0.218987094, 1.50824017,
               0.011658267, 0.0597693396, 132.709339),
    'N-SF57': (1.81651371, 0.428893641, 1.07186278,
               0.0143704198, 0.0592801172, 121.419942),
    'FUSED-SILICA': (0.6961663, 0.4079426, 0.8974794,
                     0.0046791483, 0.0135120631, 97.9340025),
    'CAF2': (0.5675888, 0.4710914, 3.8484723,
             0.0025264303, 0.0100783329, 1200.5560),
    'BAF2': (0.643356, 0.506762, 3.8261,
             0.0033396, 0.012030, 2151.70),
    'MGF2': (0.48755108, 0.39875031, 2.3120353,
             0.0018821800, 0.0089518880, 566.13559),
    'SAPPHIRE': (1.4313493, 0.65054713, 5.3414021,
                 0.0052799261, 0.0142382647, 325.017834),
}

_D_LINE = 0.5876
_F_LINE = 0.4861
_C_LINE = 0.6563


def sellmeier_index(coeffs, wavelength_um):
    """n(lambda) from 3-term Sellmeier coefficients; lambda in um, a float
    or a tensor of any shape (differentiable in it)."""
    b1, b2, b3, c1, c2, c3 = coeffs
    l2 = wavelength_um * wavelength_um
    n2 = 1.0 + b1 * l2 / (l2 - c1) + b2 * l2 / (l2 - c2) + b3 * l2 / (l2 - c3)
    if isinstance(n2, torch.Tensor):
        return torch.sqrt(n2)
    return math.sqrt(n2)


def sellmeier_nd_vd(coeffs):
    """(n_d, v_d) evaluated from Sellmeier coefficients (for the paraxial
    analytics and catalog cross-checks)."""
    nd = sellmeier_index(coeffs, _D_LINE)
    nf = sellmeier_index(coeffs, _F_LINE)
    nc = sellmeier_index(coeffs, _C_LINE)
    return nd, (nd - 1.0) / (nf - nc)


def glass(name, model='abbe'):
    """Constructor kwargs for a named glass.

    ``model='abbe'`` (default): ``{'ior_glass': n_d, 'abbe_vd': v_d}``, the
    2-term Cauchy model.  ``model='sellmeier'``: ``{'ior_glass': n_d,
    'sellmeier': (B1..C3)}``, the d-line index evaluated from the
    coefficients, so the paraxial analytics agree with the traced d line.
    ``model='const'``: the index alone."""
    key = name.upper()
    if model == 'sellmeier':
        coeffs = SELLMEIER[key]
        nd, _ = sellmeier_nd_vd(coeffs)
        return {'ior_glass': nd, 'sellmeier': coeffs}
    nd, vd = CATALOG[key]
    if model == 'const':
        return {'ior_glass': nd}
    return {'ior_glass': nd, 'abbe_vd': vd}


def glass_pair(crown, flint, model='abbe'):
    """Keyword arguments for ``DoubletLens``: the crown as glass 1, the
    flint as glass 2."""
    if model == 'sellmeier':
        s1, s2 = SELLMEIER[crown.upper()], SELLMEIER[flint.upper()]
        return {'ior_glass1': sellmeier_nd_vd(s1)[0], 'sellmeier1': s1,
                'ior_glass2': sellmeier_nd_vd(s2)[0], 'sellmeier2': s2}
    n1, v1 = CATALOG[crown.upper()]
    n2, v2 = CATALOG[flint.upper()]
    return {'ior_glass1': n1, 'abbe_vd1': v1,
            'ior_glass2': n2, 'abbe_vd2': v2}
