"""The port's exceptions.

Port of ``NotAnalyzed`` (``pylinac_tpu/core/exceptions.py:1``).
"""


class NotAnalyzed(ValueError):
    """The image/object has not been analyzed yet (call .analyze() first)."""
