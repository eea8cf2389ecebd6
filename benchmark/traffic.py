"""The one generator of every traffic mix: a closed loop of lanes over audio items.

A mix is a data file (``benchmark/traffic/<name>.json``) of parameters:

  lanes          windows decoded together in a round (the batch)
  item_seconds   the lengths of the items (files or clips) in seconds; the
                 items cycle through them, each cycle in an order drawn from
                 the seed, so every seed sends the same set of sizes
  pool           distinct recordings drawn per length; item k of a length
                 plays recording k % pool of it
  steps          forced token steps a window (the program's ``force_steps``)
  carry_prompt   a lane's later windows of an item carry the text of its
                 earlier ones in the prompt, else every window has the
                 first-window prompt
  stagger        lanes start their first item at offsets spread evenly over
                 an item's windows, in an order drawn from the seed

The prompt is the family's: a function of the text a lane carries (none
for an item's first window), and the number of tokens of text it keeps.

A lane takes its item's windows in order, one a round, 30 s apart (the
window rules' seek_delta is a transcription outcome of random weights and
is not followed), and takes the next item when one ends. A window counts
the audio it covers: 30 s, or what is left of the item.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from benchmark.inputs import sub_seed

@dataclasses.dataclass
class Window:
    """One lane's window in a round, as the program was asked for it."""

    lane: int
    item: int
    seek: int            # mel frames
    seek_end: int
    audio_s: float
    prompt: list


@dataclasses.dataclass
class _Lane:
    item: int = -1
    windows: int = 0
    index: int = 0
    past: list = dataclasses.field(default_factory=list)


class Traffic:
    """``prompt(past)``: a window's prompt from the text its lane carries
    (``[]`` for an item's first window, or where the mix carries none);
    ``keep``: the tokens of text a lane carries."""

    def __init__(self, mix: dict, seed: int, window_frames: int, prompt, keep: int):
        self.mix = mix
        self.lanes = mix["lanes"]
        self.steps = mix["steps"]
        self.window_frames = window_frames
        self.window_s = window_frames / 100
        self.keep = keep
        self.prompt = prompt
        self.rng = np.random.default_rng(sub_seed(seed, 3))
        self.lengths = [float(s) for s in mix["item_seconds"]]
        self.order: list[int] = []       # length index of item k
        self.state = [_Lane() for _ in range(self.lanes)]
        self.next_item = 0
        offsets = [0] * self.lanes
        if mix.get("stagger"):
            n = self.item_windows(0)
            offsets = [(i * n) // self.lanes for i in self.rng.permutation(self.lanes)]
        for lane, off in zip(self.state, offsets):
            self._take(lane)
            lane.index = min(off, lane.windows - 1)

    def item_seconds(self, item: int) -> float:
        while len(self.order) <= item:
            self.order.extend(self.rng.permutation(len(self.lengths)).tolist())
        return self.lengths[self.order[item]]

    def item_windows(self, item: int) -> int:
        return max(1, math.ceil(self.item_seconds(item) / self.window_s - 1e-9))

    def recording(self, item: int) -> tuple[int, float]:
        """(recording index, seconds) that item ``item`` plays."""
        self.item_seconds(item)
        k = self.order[item]
        return (item // len(self.lengths)) % self.mix["pool"] * len(self.lengths) + k, self.lengths[k]

    def recordings(self) -> list[tuple[int, float]]:
        """Every (recording index, seconds) the mix can play."""
        return [(p * len(self.lengths) + k, s) for p in range(self.mix["pool"])
                for k, s in enumerate(self.lengths)]

    def _take(self, lane: _Lane) -> None:
        lane.item, lane.index, lane.past = self.next_item, 0, []
        lane.windows = self.item_windows(lane.item)
        self.next_item += 1

    def round(self) -> list[Window]:
        """The next round's windows, one per lane."""
        out = []
        for i, lane in enumerate(self.state):
            if lane.index >= lane.windows:
                self._take(lane)
            secs = self.item_seconds(lane.item)
            prompt = self.prompt(lane.past if self.mix.get("carry_prompt") else [])
            out.append(Window(lane=i, item=lane.item, seek=lane.index * self.window_frames,
                              seek_end=int(round(secs * 100)),
                              audio_s=min(self.window_s, secs - lane.index * self.window_s),
                              prompt=prompt))
        return out

    def done(self, win: Window, tokens: np.ndarray, result_len: int) -> None:
        """A window's result is back: carry its text, move its lane on."""
        lane = self.state[win.lane]
        lane.past = (lane.past + [int(t) for t in tokens[:result_len]])[-self.keep:]
        lane.index += 1
