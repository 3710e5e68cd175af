"""The share of the traced fits' wall outside the port's fit span
(`program.tree_ensemble`: the rounds on the device, through the trees'
fetch): content keying, the bin and stage caches, the model's assembly."""


def read(rec):
    fits = rec["fits"]
    wall = sum(f["wall_s"] for f in fits)
    inside = sum(f["program_s"] for f in fits)
    if not fits or wall <= 0 or inside <= 0:
        return None
    return 100.0 * (wall - inside) / wall
