"""Several controls batched into one (port of ``torchcde_tpu/utils/tuple_control.py``).

With a tuple state z0 and a vector field returning a tuple, a
``TupleControl`` drives a tuple-state CDE through ``cdeint``: member i of the
state reads the derivative of control i.  The error texts are the JAX
package's.
"""

import numpy as np
import torch

from ..interpolation.base import InterpolationBase
from .misc import host_array


def _values(x):
    """Times as host NumPy values, for comparing two controls' grids."""
    return host_array(x) if isinstance(x, torch.Tensor) else np.asarray(x)


class TupleControl(InterpolationBase):
    def __init__(self, *controls):
        if len(controls) == 0:
            raise ValueError("Expected one or more controls to batch together.")

        interval = controls[0].interval
        grid_points = controls[0].grid_points
        same_grid_points = True
        for control in controls[1:]:
            if bool(np.any(_values(control.interval) != _values(interval))):
                raise ValueError("Can only batch together controls over the same interval.")
            if same_grid_points:
                other = control.grid_points
                if tuple(other.shape) != tuple(grid_points.shape):
                    same_grid_points = False
                elif bool(np.any(_values(other) != _values(grid_points))):
                    same_grid_points = False

        self.controls = tuple(controls)
        self._same_grid_points = same_grid_points

    @property
    def interval(self):
        return self.controls[0].interval

    @property
    def grid_points(self):
        if not self._same_grid_points:
            raise RuntimeError("Batch of controls have different grid points.")
        return self.controls[0].grid_points

    def evaluate(self, t):
        return tuple(control.evaluate(t) for control in self.controls)

    def derivative(self, t):
        return tuple(control.derivative(t) for control in self.controls)
