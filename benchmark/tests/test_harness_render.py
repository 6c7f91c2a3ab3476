"""The frozen renderer makes the port's frames byte for byte."""

import numpy as np
import pytest

from vobench import render


@pytest.mark.parametrize("dist", [None, [-0.296079, 0.099771, 0.000222, 0.000109, 0.0],
                                  [0.2624, -0.9531, -0.0054, 0.0026, 1.1633]])
def test_frames_equal_the_ports(dist):
    from droplet_visual_odometry_tpu_torch.data import synthetic

    kw = dict(n_frames=5, width=240, height=180, fx=190.0, fy=189.0, cx=121.3, cy=88.6, n_landmarks=150,
              landmark_size=0.07, orbit_sweep=0.6, dolly=0.5, loop=True, noise_std=1.5, seed=2**31 + 11,
              distortion=None if dist is None else np.asarray(dist))
    ours = render.render(render.SyntheticConfig(**kw), workers=2)
    port = synthetic.render_sequence(synthetic.SyntheticConfig(**kw))
    assert np.array_equal(ours.frames, port.frames)
    assert np.array_equal(ours.marker_corners, port.marker_corners, equal_nan=True)
    assert np.array_equal(ours.marker_poses, port.marker_poses)
    assert np.array_equal(ours.marker_present, port.marker_present)
    assert np.array_equal(ours.camera.K, port.camera.K) and np.array_equal(ours.camera.dist, port.camera.dist)
