"""The busiest expert's rows over the mean expert's, averaged over the MoE
layers, in the MoE encode window (x): from the model's [layers, experts]
counter of the rows routed to each expert, accumulated on the card and
read once when the window closes (counts['expert_rows']; layers that
route no row, the dense ones, left out). 1 is an even load; the grouped
expert products wait for the busiest expert."""


def read(run):
    counted = run.counts.get("expert_rows")
    if not counted:
        return None
    ratios = [max(layer) * len(layer) / sum(layer) for layer in counted
              if sum(layer) > 0]
    if not ratios:
        return None
    return sum(ratios) / len(ratios)
