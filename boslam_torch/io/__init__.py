from boslam_torch.io.g2o import ParsedG2O, parse_g2o, write_g2o

__all__ = ["ParsedG2O", "parse_g2o", "write_g2o"]
