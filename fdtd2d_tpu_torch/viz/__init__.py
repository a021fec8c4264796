from fdtd2d_tpu_torch.viz.render import (
    field_to_rgb, capture_snapshot, plot_Ez, save_frames, make_video_from_frames,
    render_video,
)

__all__ = [
    "field_to_rgb", "capture_snapshot", "plot_Ez", "save_frames",
    "make_video_from_frames", "render_video",
]
