"""AsyncSLAMSystem: the reference's three threads over immutable map
snapshots.

Port of orb_slam_tpu/pipeline/async_system.py:44-305: the overrides
`_apply_counters`, `_mapper_accepting`, `_dispatch_keyframe` and
`_publish_mapped_pose` (:79-93), `_merge_pending` (:95-115),
`_mapper_loop` (:117-143), `_run_loop_closing` and `_loop_loop`
(:145-214), and `request_stop`, `_release_parked`, `release`, `finish`,
`close` and `reset` (:216-305). The reference runs Tracking,
LocalMapping and LoopClosing as three OS threads coordinated by a dozen
mutexes, queues and flags (SURVEY.md §2.3); a MapState is never edited in
place (slam_map/map_state.py), so the same concurrency is one writer:

  * the TRACKER (the caller's thread) only reads `self.map`, a reference
    to an immutable snapshot; its visibility counters are buffered as
    deltas;
  * the MAPPER thread drains the keyframe queue (LocalMapping.cc:108-129),
    runs local mapping, merges the tracker's deltas through the
    merge-forwarding table and publishes each new snapshot with one
    reference assignment;
  * the LOOP thread (LoopClosing.cc:56-81) takes each processed keyframe,
    runs detection and the Sim3 against the current snapshot, and for a
    verified loop parks the mapper (RequestStop, LoopClosing.cc:401-406),
    corrects the map as the only writer, then releases it. The keyframe
    database is shared under its own lock (KeyFrameDatabase::mMutex).
InterruptBA: a queued keyframe sets an abort event that local mapping
polls between stages and BA phases (LocalMapping.cc:112, 519-522).
Backpressure: `_mapper_accepting` is False while the queue is non-empty
or the mapper is busy (LocalMapping.cc:507-517). Stop/Release:
`request_stop`/`release` park the mapper for an exclusive writer.

One CUDA stream. All three threads launch on their current stream, and
each thread's current stream is the device's default stream; the
hand-written kernels launch on `torch.cuda.current_stream()` too. So the
card runs all work in launch order, and that order is what makes the
snapshot design safe with PyTorch's caching allocator: when the mapper
drops the last reference to a snapshot that a tracker kernel still reads,
the freed block is reused only by work queued after that kernel. (JAX's
threads share XLA's one compute stream in the same way.) A thread does not
get its own `torch.cuda.Stream` here: that needs `record_stream` or events
on every tensor that crosses threads, and a profile to show it pays. The
same order means that the tracker's host reads (`_apply_chunk` copies
four tensors to the host after each chunk) wait for all device work the
mapper and loop threads queued before them; the interpreter lock is the
other shared resource. With `SlamConfig.mesh` set, the mapper's BA also
queues work on the mesh's other devices, each on its default stream. Only
the mapper thread touches them, inside `bundle_adjust`, and PyTorch
orders a copy between two cards after the work queued on both devices'
streams, so the rule holds on each device and the shards are back on the
system's card before the mapper publishes a snapshot.

Keeping up. The tracker is not throttled: it takes frames as fast as the
caller gives them, and a keyframe is admitted only while the mapper is
idle (c1b) or after `max_frames_between_kf` frames (c1a). A caller that
hands frames over faster than the mapper integrates a keyframe (an
offline loop over a directory, as the JAX package's AsyncSLAMSystem is
driven) runs the tracker past the mapped region where the path needs a
keyframe every frame or two, and the camera is lost (ROADMAP C17). A
caller paced as a camera sends its frames, as the reference's examples
pace a sequence, keeps it where one integration fits in a frame
(`profile_paths.PacedFeed`).

State a thread inherits: autograd mode is per thread (the port computes
no gradients through the map), TF32 settings are per process (the CLI
and chip_smoke.py turn them off before a system is built). The tracker's
generator (`SLAMSystem._gen`: initialisation and relocalisation) and the
loop closer's (`LoopCloser._gen`) are each drawn from by one thread only,
and only the tracker launches the kernels K1 and K2. Each thread makes
the system's card its current device. A mapper or loop error is stored
and raised by `finish()`.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time

import torch

from orb_slam_tpu_torch.pipeline.system import FrameData, SLAMSystem, SlamConfig


class AsyncSLAMSystem(SLAMSystem):
    """SLAMSystem whose local mapping and loop closing run on their own
    threads, started at construction; `finish()` drains them and `close()`
    joins them."""

    def __init__(self, cfg: SlamConfig = None, device="cuda"):
        self._lock = threading.Lock()
        self._kf_queue: queue.Queue = queue.Queue()
        self._abort_ba = threading.Event()
        self._stop_requested = threading.Event()
        # owner of the stop/release park window: the loop thread's
        # correction and a tracker-side reset() both park the mapper; with
        # an owner, a reset's release() cannot un-park the mapper in the
        # middle of a loop correction (two map writers)
        self._park_lock = threading.Lock()
        self._stopped = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._pending_deltas = []
        self._shutdown = False
        self._mapper_error = None
        self._loop_queue: queue.Queue = queue.Queue()
        self._loop_idle = threading.Event()
        self._loop_idle.set()
        self._loop_wants_park = False
        self._loop_error = None
        super().__init__(cfg, device=device)
        self._thread = threading.Thread(target=self._mapper_loop, daemon=True)
        self._thread.start()
        # the loop thread waits on its queue; keyframes reach it only after
        # the initialisation has built the loop closer
        self._loop_thread = None
        if self.cfg.enable_loop_closing:
            self._loop_thread = threading.Thread(target=self._loop_loop,
                                                 daemon=True)
            self._loop_thread.start()

    def _on_device(self):
        """The system's card as the thread's current device."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # ------------------------------------------------------------- overrides

    def _apply_counters(self, res):
        with self._lock:
            self._pending_deltas.append((res.visible_inc, res.found_inc))

    def _mapper_accepting(self) -> bool:
        return self._kf_queue.empty() and self._idle.is_set()

    def _dispatch_keyframe(self, frame: FrameData, obs, n_inliers: int, pose):
        self._abort_ba.set()  # InterruptBA
        self._kf_queue.put((frame, obs, n_inliers, pose))

    def _publish_mapped_pose(self, new_kf: int):
        pass  # the tracker owns last_pose

    # ----------------------------------------------------------- mapper loop

    def _merge_pending(self):
        """The tracker's buffered counter deltas into the map. They were
        taken against older snapshots, so each point's credit goes through
        the merge-forwarding table (IncreaseVisible/Found follow the
        Replace pointer, MapPoint.cc:141-148); a dead end drops it."""
        with self._lock:
            deltas, self._pending_deltas = self._pending_deltas, []
        if not deltas:
            return
        dev = self.device
        vis = sum(v.to(dev, torch.int32) for v, _ in deltas)
        fnd = sum(f.to(dev, torch.int32) for _, f in deltas)
        f = torch.from_numpy(self.pt_forward).to(dev)
        ok = f >= 0
        tgt = f[ok].long()
        vis_sum = torch.zeros_like(vis).index_add_(0, tgt, vis[ok])
        fnd_sum = torch.zeros_like(fnd).index_add_(0, tgt, fnd[ok])
        m = self.map
        self.map = m.replace(pt_visible=m.pt_visible + vis_sum,
                             pt_found=m.pt_found + fnd_sum)

    def _mapper_loop(self):
        with self._on_device():
            while not self._shutdown:
                if self._stop_requested.is_set():
                    self._stopped.set()
                    time.sleep(0.02)  # parked
                    continue
                self._stopped.clear()
                try:
                    item = self._kf_queue.get(timeout=0.02)
                except queue.Empty:
                    self._idle.set()
                    continue
                self._idle.clear()
                self._abort_ba.clear()
                frame, obs, n_inliers, pose = item
                try:
                    self._merge_pending()
                    self._integrate_keyframe(
                        frame, obs, n_inliers, pose=pose,
                        abort=self._abort_ba.is_set)
                except Exception as e:  # raised by finish()
                    self._mapper_error = e
                if self._kf_queue.empty():
                    self._idle.set()

    # ------------------------------------------------------------ loop thread

    def _run_loop_closing(self, slot: int):
        """Queue the processed keyframe to the loop thread
        (LoopClosing::InsertKeyFrame, LocalMapping.cc:87)."""
        self._loop_idle.clear()
        self._loop_queue.put(slot)

    def _loop_loop(self):
        """LoopClosing::Run (LoopClosing.cc:56-81): detection and the Sim3
        against the current snapshot; for a verified loop, the mapper
        parked and the correction made as the only map writer."""
        with self._on_device():
            while not self._shutdown:
                try:
                    slot = self._loop_queue.get(timeout=0.02)
                except queue.Empty:
                    self._loop_idle.set()
                    continue
                try:
                    if self._close_loop(slot) is None:
                        break
                except Exception as e:  # raised by finish()
                    self._loop_error = e
                finally:
                    if self._loop_queue.empty():
                        self._loop_idle.set()

    def _close_loop(self, slot: int):
        """One loop-closing pass on the loop thread: False when no loop was
        closed, True when one was, None when shutdown interrupted the
        wait for the park window."""
        lc = self.loop_closer
        if lc is None or not bool(self.map.kf_valid[slot]):
            return False
        with self._stage("loop detect"):
            candidates, _, _ = lc.detect(self, slot)
        if not candidates:
            return False
        hit = lc.compute_sim3(self, slot, candidates)
        if hit is None:
            return False
        cand, S12, _ = hit
        # CorrectLoop in an exclusive-writer window (LoopClosing.cc:401-406
        # stop ... 550 release). The reference spin-waits until
        # LocalMapping parks, so an integration under way completes first.
        # The window is owned (the park lock): a tracker reset() waits for
        # the correction instead of un-parking the mapper mid-surgery.
        self._loop_wants_park = True
        try:
            while not self._park_lock.acquire(timeout=0.5):
                if self._shutdown:
                    return None
        finally:
            self._loop_wants_park = False
        self._stop_requested.set()
        while not self._stopped.wait(timeout=1.0):
            if self._shutdown:
                self._stop_requested.clear()
                self._park_lock.release()
                return None
        try:
            closed = False
            if bool(self.map.kf_valid[slot]) and bool(self.map.kf_valid[cand]):
                closed = lc.correct(self, slot, cand, S12)
                if closed:
                    self.n_loops_closed += 1
                    # the loop area is covisible now: the tracker's local
                    # map re-anchors there
                    self._refresh_local_mask(slot)
            return closed
        finally:
            self._release_parked()
            self._park_lock.release()

    # ---------------------------------------------------------- control plane

    def request_stop(self):
        """Park the mapper (LocalMapping::RequestStop + Stop). Blocks until
        the current owner of the park window (a loop correction under way)
        releases it; the caller becomes the owner and must call
        release()."""
        self._park_lock.acquire()
        self._stop_requested.set()
        self._stopped.wait(timeout=30.0)

    def _release_parked(self):
        """Resume the mapper and drop the queued keyframes
        (LocalMapping::Release clears the queue, LocalMapping.cc:507-517).
        The caller owns the park window."""
        while not self._kf_queue.empty():
            try:
                self._kf_queue.get_nowait()
            except queue.Empty:
                break
        self._stop_requested.clear()

    def release(self):
        """The counterpart of request_stop(): resume the mapper and give up
        the park window."""
        self._release_parked()
        try:
            self._park_lock.release()
        except RuntimeError:
            pass  # not owned: a release without request_stop

    def finish(self, timeout: float = 120.0):
        """Wait until both queues are empty and both threads idle, merge
        the tracker's last deltas, and raise a stored mapper or loop
        error."""
        t0 = time.time()
        while not (self._kf_queue.empty() and self._idle.is_set()
                   and self._loop_queue.empty()
                   and self._loop_idle.is_set()):
            if time.time() - t0 > timeout:
                raise TimeoutError("mapper/loop thread did not drain")
            time.sleep(0.01)
        self._merge_pending()
        if self._mapper_error is not None:
            raise self._mapper_error
        if self._loop_error is not None:
            raise self._loop_error

    def close(self):
        """Stop both threads and join them."""
        self._shutdown = True
        self._thread.join(timeout=10.0)
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=10.0)

    def reset(self):
        """Tracking::Reset (src/Tracking.cc:1026-1094): empty the loop
        queue, park the mapper, drop the deltas, rebuild the state,
        release. Taking the park window waits for a loop correction under
        way; the loop queue is emptied first so that no other correction
        starts while the state is rebuilt."""
        if hasattr(self, "_loop_queue"):
            while not self._loop_queue.empty():
                try:
                    self._loop_queue.get_nowait()
                except queue.Empty:
                    break
        if hasattr(self, "_thread") and self._thread.is_alive():
            self.request_stop()
            try:
                if (self._loop_thread is not None
                        and self._loop_thread.is_alive()):
                    # a loop correction waiting for the window we now own
                    # cannot go idle: let it through; it finds no valid
                    # keyframe on the rebuilt map (RequestReset)
                    t0 = time.time()
                    while (not self._loop_idle.is_set()
                           and not self._loop_wants_park
                           and time.time() - t0 < 60.0):
                        time.sleep(0.005)
                with self._lock:
                    self._pending_deltas = []
                super().reset()
            finally:
                self.release()
            return
        with self._lock:
            self._pending_deltas = []
        super().reset()
