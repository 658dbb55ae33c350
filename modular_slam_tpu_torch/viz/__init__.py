"""Visualization subsystem (counterpart of modular_slam_tpu/viz/), the
answer to the reference's Qt6/OpenGL viewer app (src/app/viewer/).

The reference viewer is an image viewer with keypoint/landmark
observation overlays (image_viewer.cpp:27-58), a HOT-colormapped depth
view (depth_image_viewer.cpp:9-44), an OpenGL point-cloud/keyframe-frustum
scene (pointcloud_viewer.cpp), live stats (slam_statistics_widget.cpp:
28-34) and auto-generated parameter widgets (parameters_viewer.cpp:
71-83).  The equivalents here are headless renderers (numpy, matplotlib)
plus a dependency-free live web viewer (viz/server.py) with working
parameter write-back.
"""

from modular_slam_tpu_torch.viz.overlay import (
    OverlayData,
    depth_colormap,
    draw_observations,
    make_overlay_fn,
)
from modular_slam_tpu_torch.viz.scene import (
    frustum_lines,
    pointcloud_from_rgbd,
    render_scene,
)
from modular_slam_tpu_torch.viz.png import write_png

__all__ = [
    "OverlayData",
    "depth_colormap",
    "draw_observations",
    "make_overlay_fn",
    "frustum_lines",
    "pointcloud_from_rgbd",
    "render_scene",
    "write_png",
]
