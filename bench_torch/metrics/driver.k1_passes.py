"""K1 passes over the blocks an encode call, from the program's
EncodeTrace.capacities_tried (every pass, the rebuild's included),
averaged over the window's calls."""


def read(run):
    passes = [len(rt["info"]["capacities_tried"]) for rt in run.records
              if "capacities_tried" in rt["info"]]
    return sum(passes) / len(passes) if passes else None
