"""Feature DSL — the part of ``transmogrifai_tpu/dsl.py`` the port carries
so far: ``transmogrify`` (RichFeaturesCollection.transmogrify) and
``Feature.sanity_check``. Importing the package attaches the methods."""
from __future__ import annotations

from typing import Sequence

from .features import Feature

__all__ = ["transmogrify"]


def transmogrify(features: Sequence[Feature]) -> Feature:
    """One-call automated feature engineering: features → one OPVector."""
    from .ops.transmogrifier import transmogrify as _tm
    return _tm(features)


def _sanity_check(self: Feature, features: Feature,
                  remove_bad_features: bool = True, **kw) -> Feature:
    """``label.sanity_check(vector)``: the SanityChecker's cleaned vector."""
    from .ops.sanity_checker import SanityChecker
    checker = SanityChecker(remove_bad_features=remove_bad_features, **kw)
    checker.set_input(self, features)
    return checker.get_output()


Feature.sanity_check = _sanity_check
