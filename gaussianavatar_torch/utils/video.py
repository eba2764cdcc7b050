"""Frame folder -> mp4 (the port's copy of gaussianavatar_tpu/utils/video.py)."""

from __future__ import annotations

import os


def save_video(frames_dir: str, out_path: str, size=(1024, 1024), fps: int = 30):
    import cv2

    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    writer = cv2.VideoWriter(out_path, fourcc, fps, size)
    names = sorted(n for n in os.listdir(frames_dir) if n.endswith(".png"))
    for name in names:
        frame = cv2.imread(os.path.join(frames_dir, name))
        if frame is not None:
            writer.write(frame)
    writer.release()
    return out_path
