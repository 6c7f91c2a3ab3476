"""backend/ — see the package docstring of droplet_visual_odometry_tpu_torch."""
