from .x2x import ExpertParams, OmniVideoX2XUnified, video_to_uint8_frames

__all__ = ["ExpertParams", "OmniVideoX2XUnified", "video_to_uint8_frames"]
