"""The share of the lane-bounces of a render's traced chunks that ran on lanes
already dead, from the system's counters: 100 x (1 - live_lane_bounces /
lane_bounces), in %."""

from benchmark import spans


def read(summary: dict):
    return spans.dead_share(summary, "ptt.chunk")
