"""See the module of the same name in ``mola_fe_lidar_tpu``."""
