"""Linear interpolation coefficients: the NaN-free fast path.

Port of ``torchcde_tpu/interpolation/linear.py::linear_interpolation_coeffs``
for data without missing values, where the coefficients are the data itself.
NaN infill, ``rectilinear`` and ``LinearInterpolation`` are ROADMAP queue 1
item 7 and raise here rather than return unfilled data.
"""

import torch

from ..utils.misc import validate_input_path

_NOT_PORTED = (
    "{} is not ported to torchcde_tpu_torch yet (ROADMAP.md queue 1, "
    "'NaN and irregular preprocessing')."
)


def linear_interpolation_coeffs(x, t=None, rectilinear=None):
    """Knots of the linear interpolation of a batch of controls.

    x: (..., length, channels); t: optional 1-D strictly increasing times,
    defaulting to 0..length-1.  Returns ``x``: without missing values the
    knots are the data.
    """
    if rectilinear is not None:
        raise NotImplementedError(_NOT_PORTED.format("rectilinear interpolation"))
    validate_input_path(x, t)
    # One host sync; coefficient construction is offline preprocessing.
    if bool(torch.isnan(x).any()):
        raise NotImplementedError(_NOT_PORTED.format("NaN infill of missing values"))
    return x
