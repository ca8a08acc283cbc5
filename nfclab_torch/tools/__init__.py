from .analyze import detect_command, annotate_frames
