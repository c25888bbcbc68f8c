from boslam_torch.viz.draw import render_state, save_render

__all__ = ["render_state", "save_render"]
