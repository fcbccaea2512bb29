"""SPICE SPK (BSP) writer: trajectories to type-3 Chebyshev segments.

The inverse of ephem/daf.py (host-side, numpy): writes a DAF container
with one SPK type-3 segment (Chebyshev position AND velocity, uniform
records) per call. Counterpart of the reference's `Traj::to_ephemeris` ->
ANISE BSP export (md/trajectory/sc_traj.rs:158; examples/04_lro_od/
main.rs:343). Type 3 keeps the writer trivial (independent pos/vel fits,
uniform intervals) while staying readable by our own SPK parser, ANISE and
the SPICE toolkit.

Copied from nyx_tpu/io/spk.py (host-only numpy, no JAX), with the same
byte layout; `traj_to_bsp` samples the trajectory's interpolant in one
batched call.
"""

from __future__ import annotations


import numpy as np
from ..errors import ConfigError

RECLEN = 1024
_WORDS_PER_REC = RECLEN // 8
#: SPICE DAF FTP validation string (bytes 699..727 of the file record)
_FTPSTR = b"FTPSTR:\r:\n:\r\n:\r\x00:\x81:\x10\xce:ENDFTP"


def _cheb_fit(f_vals: np.ndarray, degree: int) -> np.ndarray:
    """Chebyshev coefficients [..., degree+1] interpolating values sampled
    at the degree+1 first-kind Chebyshev points (columns of f_vals)."""
    n = degree + 1
    tau = np.cos(np.pi * (2 * np.arange(n) + 1) / (2 * n))
    # chebfit wants [npts, nrhs]
    flat = f_vals.reshape(-1, n).T  # [n, n_series]
    cf = np.polynomial.chebyshev.chebfit(tau, flat, degree)  # [n, n_series]
    return cf.T.reshape(f_vals.shape[:-1] + (n,))


def write_spk_type3(
    path,
    target: int,
    center: int,
    frame_id: int,
    t0_tdb: float,
    t1_tdb: float,
    sample_fn,
    intlen_s: float,
    degree: int = 11,
    segment_id: str = "NYX_TPU_TRAJ",
) -> str:
    """Write a single-segment type-3 BSP.

    sample_fn(t_tdb [K]) -> [K, 6] km / km/s states rel `center` in J2000.
    """
    n_rec = max(1, int(np.ceil((t1_tdb - t0_tdb) / intlen_s)))
    init = float(t0_tdb)
    # records tile [t0, t1] exactly: a record reaching past the sampled
    # span would be fit to clamped (extrapolated) values
    intlen = float(t1_tdb - t0_tdb) / n_rec
    n_pts = degree + 1
    tau = np.cos(np.pi * (2 * np.arange(n_pts) + 1) / (2 * n_pts))

    records = []
    for i in range(n_rec):
        mid = init + (i + 0.5) * intlen
        radius = 0.5 * intlen
        ts = mid + radius * tau
        states = np.asarray(sample_fn(ts))  # [n_pts, 6]
        cf = _cheb_fit(states.T, degree)  # [6, degree+1]
        records.append(np.concatenate([[mid, radius], cf.ravel()]))
    rsize = 2 + 6 * n_pts
    body = np.concatenate(records + [[init, intlen, float(rsize), float(n_rec)]])

    # --- DAF container -------------------------------------------------
    start_word = 3 * _WORDS_PER_REC + 1  # data starts at record 4
    end_word = start_word + len(body) - 1
    free = end_word + 1

    file_rec = bytearray(RECLEN)
    file_rec[0:8] = b"DAF/SPK "
    file_rec[8:12] = np.int32(2).tobytes()  # ND
    file_rec[12:16] = np.int32(6).tobytes()  # NI
    file_rec[16:76] = b"nyx_tpu trajectory export".ljust(60)
    file_rec[76:80] = np.int32(2).tobytes()  # FWARD
    file_rec[80:84] = np.int32(2).tobytes()  # BWARD
    file_rec[84:88] = np.int32(free).tobytes()  # FREE
    file_rec[88:96] = b"LTL-IEEE"
    file_rec[699 : 699 + len(_FTPSTR)] = _FTPSTR

    # summary record: next, prev, nsum then ND doubles + NI ints (packed)
    summary = np.zeros(_WORDS_PER_REC)
    summary[0:3] = [0.0, 0.0, 1.0]
    summary[3] = t0_tdb
    summary[4] = t1_tdb
    ints = np.array(
        [target, center, frame_id, 3, start_word, end_word], dtype=np.int32
    )
    summary[5:8] = np.frombuffer(ints.tobytes(), dtype=np.float64)

    name_rec = bytearray(RECLEN)
    name_rec[:] = b" " * RECLEN
    name_rec[0:40] = segment_id.encode()[:40].ljust(40)

    n_data_rec = int(np.ceil(len(body) / _WORDS_PER_REC))
    data = np.zeros(n_data_rec * _WORDS_PER_REC)
    data[: len(body)] = body

    with open(path, "wb") as f:
        f.write(bytes(file_rec))
        f.write(summary.astype("<f8").tobytes())
        f.write(bytes(name_rec))
        f.write(data.astype("<f8").tobytes())
    return str(path)


def traj_to_bsp(
    traj,
    path,
    target: int = -10_000,
    degree: int = 11,
    intlen_s: float | None = None,
) -> str:
    """Trajectory -> BSP (sc_traj.rs to_ephemeris parity). The segment is
    written relative to the trajectory frame's center in J2000."""
    frame = traj.template.frame
    if not frame.is_inertial:
        raise ConfigError("export requires an inertial (J2000) trajectory; "
                         "use to_frame first")
    epoch0_tdb = traj.epoch0.to_tdb_seconds()
    t0 = epoch0_tdb + float(traj.ts[0])
    t1 = epoch0_tdb + float(traj.ts[-1])
    if intlen_s is None:
        # ~10 integrator steps per record keeps degree-11 fits at mm level
        mean_dt = float(np.mean(np.diff(traj.ts))) if len(traj.ts) > 1 else 60.0
        intlen_s = min(max(10.0 * mean_dt, 60.0), max(t1 - t0, 60.0))

    def sample(ts_tdb):
        t_rel = np.clip(np.asarray(ts_tdb) - epoch0_tdb, float(traj.ts[0]), float(traj.ts[-1]))
        return traj.interpolate_many(t_rel)[:, :6]

    return write_spk_type3(
        path, target, frame.center, 1, t0, t1, sample, intlen_s, degree
    )
