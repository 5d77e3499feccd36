"""Dataset reader factories — the part of ``paddle_tpu.dataset`` ported so
far: :mod:`.common` (cache location, npz loading) and :mod:`.digits` (the
real UCI handwritten digits bundled with scikit-learn). A reader creator
returns a zero-arg callable yielding one example per ``next()``."""

from paddle_tpu_torch.dataset import common, digits  # noqa: F401

__all__ = ["common", "digits"]
