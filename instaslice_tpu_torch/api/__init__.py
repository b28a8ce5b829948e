"""Constants of the port's serving plane, copied from
``instaslice_tpu/api``."""
