from .gazepoint import GazepointClient, parse_gazepoint_records

__all__ = ["GazepointClient", "parse_gazepoint_records"]
