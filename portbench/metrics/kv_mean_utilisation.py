"""KV memory layer: the pool's mean block use over the window's waves
against the dense ``slots × max_len`` reservation
(``last_stats["kv"]["mean_utilisation"]``), in percent."""


def read(ctx):
    serve = ctx.get("serve")
    if not serve or serve["kv_mean_utilisation"] is None:
        return None
    return 100.0 * serve["kv_mean_utilisation"]
