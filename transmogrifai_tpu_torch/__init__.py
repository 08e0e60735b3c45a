"""transmogrifai_tpu_torch — the PyTorch/CUDA port of ``transmogrifai_tpu``.

AutoML for tabular data on an NVIDIA H100: the typed feature DAG,
``transmogrify`` (a vectorizer for every feature type: numerics, dates,
text, lists, sets, geolocations and maps), the Rich* DSL, the
SanityChecker, the ``Workflow`` runtime and the model selectors (linear,
naive Bayes and tree families) with hand-written CUDA kernels for the
tree engine (``models/_hist.py``, ``csrc/``). Entry points run on the card unless the
caller passes ``device="cpu"``. The package imports ``torch`` and numpy,
never ``jax``.
"""
__version__ = "0.2.0"

from . import types  # noqa: F401
from .columns import Column, ColumnStore, column_from_values  # noqa: F401
from .dsl import transmogrify  # noqa: F401
from .features import Feature, FeatureBuilder  # noqa: F401
from .workflow import Workflow, WorkflowModel  # noqa: F401

__all__ = ["Workflow", "WorkflowModel", "FeatureBuilder", "Feature",
           "ColumnStore", "Column", "column_from_values", "types",
           "transmogrify"]
