"""Constants and allocation records of the port, copied from
``instaslice_tpu/api``."""
