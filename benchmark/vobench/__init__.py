"""The benchmark's harness: finding a cell's files by name, the frozen
renderer, the measured window, spans and the device trace, kernel timing
against the H100's published peaks, and the comparison that decides
`correct`. It drives droplet_visual_odometry_tpu_torch and nothing else of
the repository."""
