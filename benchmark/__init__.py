"""The benchmark of avxwindowfmindex_tpu_torch (see README.md)."""
