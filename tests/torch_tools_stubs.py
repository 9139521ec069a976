"""Picklable stand-ins for the room-type extractor's renderer and VQA
model (numpy only, so the spawned workers of
`tools.do_utils.extract_room_types_pooled` start quickly)."""
import numpy as np


def fake_render():
    def render(scan, vp, ix):
        # deterministic per (scan, vp, view): the view index in the pixels
        return np.full((4, 4, 3), ix + len(vp), np.uint8)
    return render


def fake_vqa():
    def vqa(image, question):
        assert question
        return f"room{int(image[0, 0, 0]) % 3}"
    return vqa


def failing_vqa():
    raise RuntimeError("no VQA model in this worker")
