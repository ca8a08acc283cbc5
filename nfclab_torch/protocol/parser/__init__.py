from .tree import ProtocolNode
from .dispatch import ProtocolParser, parse_frames_to_json
