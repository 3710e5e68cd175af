"""Version metadata for sml_tpu_torch.

The port's copy of `sml_tpu/version.py`: the reference courseware's
version surface (`SML/Version Info.py:10-14`, course 3.7.3) with the
framework's own version.
"""

__version__ = "0.1.0"
COURSE_COMPAT = "3.7.3"  # reference course version whose API surface we cover
