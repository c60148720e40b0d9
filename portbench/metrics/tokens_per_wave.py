"""Engine layer: tokens generated a wave (``last_stats`` ``generated`` /
``waves``), how full the decode batch ran."""


def read(ctx):
    serve = ctx.get("serve")
    if not serve or not serve["waves"]:
        return None
    return serve["generated"] / serve["waves"]
