"""The default negative prompt of the x2x pipeline (a copy of the English
one in omnivideo_tpu/configs/prompts.py): it conditions every CFG null
branch when a text encoder is attached and no negative context is given."""

SAMPLE_NEG_PROMPT_EN = (
    "overly vivid colors, overexposed, static, blurry and unclear details, "
    "subtitles, text overlays, stylized artwork, painting, illustration, "
    "still image, frozen frame, grayish overall tone, worst quality, low "
    "quality, JPEG compression artifacts, ugly, incomplete, extra fingers, "
    "poorly drawn hands, poorly drawn face, deformed, disfigured, malformed "
    "anatomy, distorted limbs, fused fingers, motionless frame, cluttered "
    "background, three legs, walking backward, expression drift, teeth "
    "flickering, uneven facial muscles, facial shivering"
)
