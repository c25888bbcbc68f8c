from boslam_torch.init.triangulation import triangulate_landmarks

__all__ = ["triangulate_landmarks"]
