"""Frame-to-frame sparse point tracker: a host-side state machine in numpy.

Counterpart of `match_descriptors` and `PointTracker` in
`yolopoint_tpu/frontend/tracker.py` (a copy: the port imports nothing of the
JAX package). A rolling window of the last `max_length` frames' keypoints;
tracks are rows `[track_id, avg_match_score, point_id_0 .. point_id_{L-1}]`
where point ids index the concatenated rolling point store and -1 marks "no
observation". Feed it the numpy outputs of `InferencePipeline.process_frame`
(`keypoints`, `kp_scores`, `descriptors` at `kp_valid`). `draw_tracks`
draws the tracks as the JAX tracker does through OpenCV (anti-aliased lines
and end dots), with `data/raster.py`'s bit-equal `line_aa` and `circle`.
"""

from __future__ import annotations

import numpy as np

from yolopoint_tpu_torch.data import raster

_MAX_SCORE = 9999.0
# the jet colour map at 10 steps (RGB in [0, 1]), by average match score
_JET = np.array(
    [
        [0.0, 0.0, 0.5], [0.0, 0.0, 0.99910873], [0.0, 0.37843137, 1.0],
        [0.0, 0.83333333, 1.0], [0.30044276, 1.0, 0.66729918],
        [0.66729918, 1.0, 0.30044276], [1.0, 0.90123457, 0.0],
        [1.0, 0.48002905, 0.0], [0.99910873, 0.07334786, 0.0], [0.5, 0.0, 0.0],
    ]
)


def match_descriptors(desc1: np.ndarray, desc2: np.ndarray, nn_thresh: float) -> np.ndarray:
    """Two-way NN matching of unit descriptors, `(D, N1) x (D, N2) -> (3, L)`
    columns `[idx1, idx2, distance]` (the original SuperPoint demo's
    `nn_match_two_way`)."""
    if desc1.shape[1] == 0 or desc2.shape[1] == 0:
        return np.zeros((3, 0))
    if nn_thresh < 0:
        raise ValueError("nn_thresh must be non-negative")
    dmat = np.sqrt(np.clip(2.0 - 2.0 * np.clip(desc1.T @ desc2, -1.0, 1.0), 0.0, None))
    idx = np.argmin(dmat, axis=1)
    scores = dmat[np.arange(dmat.shape[0]), idx]
    keep = scores < nn_thresh
    idx2 = np.argmin(dmat, axis=0)
    keep &= np.arange(len(idx)) == idx2[idx]
    out = np.zeros((3, int(keep.sum())))
    out[0] = np.flatnonzero(keep)
    out[1] = idx[keep]
    out[2] = scores[keep]
    return out


class PointTracker:
    """Fixed-memory multi-frame point track store."""

    def __init__(self, max_length: int, nn_thresh: float):
        if max_length < 2:
            raise ValueError("max_length must be >= 2")
        self.maxl = int(max_length)
        self.nn_thresh = float(nn_thresh)
        self.all_pts: list[np.ndarray] = [np.zeros((2, 0)) for _ in range(self.maxl)]
        self.last_desc: np.ndarray | None = None
        self.tracks = np.zeros((0, self.maxl + 2))
        self.track_count = 0

    def _offsets(self) -> np.ndarray:
        sizes = [0] + [p.shape[1] for p in self.all_pts[:-1]]
        return np.cumsum(sizes)

    def update(self, pts: np.ndarray, desc: np.ndarray) -> None:
        """Add a frame's observations.

        Args:
          pts: `(3, N)` or `(2, N)` `[x, y(, score)]` columns.
          desc: `(D, N)` unit descriptors.
        """
        if pts is None or desc is None:
            return
        assert pts.shape[1] == desc.shape[1]
        if self.last_desc is None:
            self.last_desc = np.zeros((desc.shape[0], 0))

        remove_size = self.all_pts[0].shape[1]
        self.all_pts.pop(0)
        self.all_pts.append(pts[:2])

        # slide the window: drop the oldest id column, shift ids, append -1
        self.tracks = np.delete(self.tracks, 2, axis=1)
        self.tracks[:, 2:] -= remove_size
        self.tracks[:, 2:] = np.maximum(self.tracks[:, 2:], -1)
        self.tracks = np.hstack([self.tracks, -np.ones((self.tracks.shape[0], 1))])

        offsets = self._offsets()
        matches = match_descriptors(self.last_desc, desc, self.nn_thresh)

        matched_new = np.zeros(pts.shape[1], bool)
        if matches.shape[1] and self.tracks.shape[0]:
            id1 = matches[0].astype(int) + offsets[-2]
            id2 = matches[1].astype(int) + offsets[-1]
            # vectorized: map previous-frame ids -> track rows
            prev_col = self.tracks[:, -2].astype(int)
            order = np.argsort(prev_col)
            pos = np.searchsorted(prev_col[order], id1)
            pos = np.clip(pos, 0, len(order) - 1)
            rows = order[pos]
            hit = prev_col[rows] == id1
            rows, id2_h, score_h = rows[hit], id2[hit], matches[2][hit]
            matched_new[matches[1].astype(int)[hit]] = True
            self.tracks[rows, -1] = id2_h
            # running average of match score (fresh tracks initialize)
            fresh = self.tracks[rows, 1] == _MAX_SCORE
            track_len = (self.tracks[rows, 2:] != -1).sum(axis=1) - 1.0
            frac = 1.0 / np.maximum(track_len, 1.0)
            avg = (1.0 - frac) * self.tracks[rows, 1] + frac * score_h
            self.tracks[rows, 1] = np.where(fresh, score_h, avg)

        # spawn tracks for unmatched points
        new_ids = np.flatnonzero(~matched_new) + offsets[-1]
        new_tracks = -np.ones((len(new_ids), self.maxl + 2))
        new_tracks[:, -1] = new_ids
        new_tracks[:, 0] = self.track_count + np.arange(len(new_ids))
        new_tracks[:, 1] = _MAX_SCORE
        self.tracks = np.vstack([self.tracks, new_tracks])
        self.track_count += len(new_ids)

        # prune tracks with no remaining observations
        self.tracks = self.tracks[np.any(self.tracks[:, 2:] >= 0, axis=1)]
        self.last_desc = desc.copy()

    def get_tracks(self, min_length: int) -> np.ndarray:
        """Tracks with >= min_length observations AND a hit in the latest
        frame."""
        if min_length < 1:
            raise ValueError("min_length too small")
        good = (self.tracks[:, 2:] != -1).sum(axis=1) >= min_length
        headed = self.tracks[:, -1] != -1
        return self.tracks[good & headed].copy()

    def draw_tracks(self, out: np.ndarray, tracks: np.ndarray) -> np.ndarray:
        """Overlay `tracks` (rows of `get_tracks`) on a uint8 `(H, W, 3)`
        image, in place: each observed step an anti-aliased line coloured by
        the track's average match score (`_JET`), a dot at the newest point."""
        offsets = self._offsets()
        n = len(self.all_pts)
        for track in tracks:
            clr = _JET[int(np.clip(np.floor(track[1] * 10), 0, 9))] * 255
            for i in range(n - 1):
                if track[i + 2] == -1 or track[i + 3] == -1:
                    continue
                pt1 = self.all_pts[i][:2, int(track[i + 2] - offsets[i])]
                pt2 = self.all_pts[i + 1][:2, int(track[i + 3] - offsets[i + 1])]
                p1 = (int(round(pt1[0])), int(round(pt1[1])))
                p2 = (int(round(pt2[0])), int(round(pt2[1])))
                raster.line_aa(out, p1, p2, clr)
                if i == n - 2:
                    raster.circle(out, p2, 1, (255, 0, 0), aa=True)
        return out
