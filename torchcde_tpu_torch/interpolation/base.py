"""The control-path protocol (port of ``torchcde_tpu/interpolation/base.py``).

A control is a continuous path X(t) with a derivative; ``cdeint`` duck-types
on ``.derivative``.  Controls hold plain tensors, so no registration with any
framework is needed.
"""

import abc


class InterpolationBase(abc.ABC):
    """Abstract control path: a continuous X(t) with a derivative."""

    @property
    @abc.abstractmethod
    def grid_points(self):
        raise NotImplementedError

    @property
    @abc.abstractmethod
    def interval(self):
        raise NotImplementedError

    @abc.abstractmethod
    def evaluate(self, t):
        raise NotImplementedError

    @abc.abstractmethod
    def derivative(self, t):
        raise NotImplementedError
