"""Ground-truth kinds, one module each: prepare(spec, gen, device) -> state,
shade(spec, state, eye, d) -> (images [B, H, W, 3], depths [B, H, W])."""
