"""Display settings: the colour maps of the plots and the length at which
paths are cut. A copy of ``pylinac_tpu/settings.py`` (``:1-15``)."""

DICOM_COLORMAP = "gray"
ARRAY_COLORMAP = "viridis"
PATH_TRUNCATION_LENGTH = 80


def get_dicom_cmap() -> str:
    """The colormap used for DICOM image plots."""
    return DICOM_COLORMAP


def get_array_cmap() -> str:
    """The colormap used for array plots."""
    return ARRAY_COLORMAP
