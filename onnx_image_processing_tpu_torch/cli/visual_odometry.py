"""Visual-odometry CLI of the port: streaming frame matching on a device ->
host pose -> trajectory.

    python -m onnx_image_processing_tpu_torch.cli.visual_odometry -i frames/ --device cuda

Port of ``onnx_image_processing_tpu/cli/visual_odometry.py``: the same flags
(``--device {cuda,cpu}`` in place of ``--platform``), frame sources and
gating state machine (insufficient-match skip, stationary-camera gating by
RMS flow with reference-frame aging, inlier-ratio pose rejection). The
matchers run on the device; the host side is the port's own ``vo`` (the
pose: OpenCV RANSAC, or recoverPose on the in-graph E), ``utils`` and
``cli.common``. Frames, the pose step, ``--display`` and ``--plot`` need
OpenCV, PIL and matplotlib; they are imported where used, so importing this
module needs none of them.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch

from .. import models
from ..core import trace
from ..vo import (CameraIntrinsics, Trajectory, create_camera, estimate_pose_ransac,
                  recover_pose)
from .common import add_device_arg, load_image_from_array, select_device


class VideoReader:
    """Uniform frame source over a video file, an image directory or a
    camera (the JAX CLI's reader)."""

    def __init__(self, source: str, camera_type: str = "opencv",
                 camera_id: int = 0, camera_width: int = 640,
                 camera_height: int = 480, camera_fps: int = 30):
        self.is_camera = source == "camera"
        self.camera = None
        self._cap = None
        self._files: list[str] = []
        self._idx = 0
        if self.is_camera:
            if camera_type == "opencv":
                self.camera = create_camera(camera_type, device_id=camera_id)
            else:
                self.camera = create_camera(camera_type, width=camera_width,
                                            height=camera_height,
                                            fps=camera_fps)
            if not self.camera.open():
                raise RuntimeError(f"failed to open camera {camera_type}")
            if camera_type == "opencv":
                self.camera.set_resolution(camera_width, camera_height)
            self.total_frames = float("inf")
        elif os.path.isdir(source):
            for ext in ("*.png", "*.jpg", "*.jpeg", "*.bmp"):
                self._files.extend(glob.glob(os.path.join(source, ext)))
            self._files.sort()
            if not self._files:
                raise RuntimeError(f"no images found in {source}")
            self.total_frames = len(self._files)
        else:
            import cv2

            self._cap = cv2.VideoCapture(source)
            if not self._cap.isOpened():
                raise RuntimeError(f"failed to open video {source}")
            self.total_frames = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT)) \
                or float("inf")

    def read(self):
        if self.camera is not None:
            return self.camera.read()
        if self._cap is not None:
            return self._cap.read()
        if self._idx >= len(self._files):
            return False, None
        import cv2

        frame = cv2.imread(self._files[self._idx])
        self._idx += 1
        return frame is not None, frame

    def release(self):
        if self.camera is not None:
            self.camera.release()
        if self._cap is not None:
            self._cap.release()


def to_host(outputs) -> list[np.ndarray]:
    """The outputs in ONE device-to-host copy: packed as float32 (exact for
    the f32 coordinates, scores and E, and for bool masks), split and cast
    back to bool where they were. Spans (``core/trace.py``): ``io.fetch``
    and one ``io.sync`` count."""
    with trace.span("io.fetch"):
        trace.count("io.sync")
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in outputs]).cpu().numpy()
    host, i = [], 0
    for t in outputs:
        a = flat[i:i + t.numel()].reshape(tuple(t.shape))
        i += t.numel()
        host.append(a.astype(bool) if t.dtype == torch.bool else a)
    return host


def run_visual_odometry(
    matcher_fn,
    reader: VideoReader,
    intrinsics: CameraIntrinsics,
    model_height: int,
    model_width: int,
    has_essential: bool,
    device: str | torch.device,
    k_inv=None,
    match_threshold: float = 0.1,
    ransac_threshold: float = 1.0,
    max_matches: int = 100,
    min_matches: int = 20,
    min_inlier_ratio: float = 0.5,
    min_motion_pixels: float = 1.0,
    max_reference_age: int = 30,
    skip_frames: int = 1,
    max_frames: int | None = None,
    verbose: bool = True,
    display: bool = False,
    extract_fn=None,
) -> Trajectory:
    """Frame loop with the reference's gating state machine.

    With ``extract_fn`` (streaming, the default for models that split),
    ``matcher_fn`` is the feature-level match tail and the loop caches the
    reference frame's features instead of its image, so each frame runs
    detect/describe once. Each frame makes one device-to-host copy of the
    extraction outputs (and E). The fps lines leave out the time jitted
    functions spend capturing their CUDA graphs (the first frame's calls),
    and the last line says how long that was.
    """
    def upload(image: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(image).to(device)

    trajectory = Trajectory()
    k_inv_dev = (torch.as_tensor(k_inv, dtype=torch.float32, device=device)
                 if has_essential else None)

    if reader.is_camera:  # let auto-exposure settle
        for _ in range(10):
            ok, _ = reader.read()
            if not ok:
                break

    ok, prev_frame = reader.read()
    if not ok:
        raise RuntimeError("failed to read first frame")
    prev_image = upload(load_image_from_array(prev_frame, model_height, model_width))
    prev_feats = extract_fn(prev_image) if extract_fn is not None else None

    frame_count = processed = 0
    total_matches = total_inliers = 0
    ref_age = 0
    t_start = time.time()
    capture_start = _capture_seconds(matcher_fn, extract_fn)

    def captured() -> float:
        return _capture_seconds(matcher_fn, extract_fn) - capture_start

    while True:
        ok, curr_frame = reader.read()
        if not ok:
            break
        frame_count += 1
        if frame_count % (skip_frames + 1) != 0:
            continue
        processed += 1
        if max_frames is not None and processed > max_frames:
            break

        curr_image = upload(load_image_from_array(curr_frame, model_height, model_width))
        if extract_fn is not None:
            # Streaming: only the new frame's features are extracted; the
            # cached reference features skip detect/describe entirely.
            curr_feats = extract_fn(curr_image)
            fn_args = (prev_feats, curr_feats)
        else:
            curr_feats = None
            fn_args = (prev_image, curr_image)
        # The matcher carries the mutual-NN extraction (see main()): only
        # the fixed-size matched pairs (and E) cross to the host.
        if has_essential:
            mk1a, mk2a, _, valid, e = to_host(matcher_fn(*fn_args, k_inv_dev)[:5])
        else:
            mk1a, mk2a, _, valid = to_host(matcher_fn(*fn_args)[:4])
            e = None

        keep = valid[0]
        mk1, mk2 = mk1a[0][keep], mk2a[0][keep]
        n_matches = len(mk1)
        total_matches += n_matches

        status = None
        pose_updated = False
        n_inliers = 0
        last_inlier_mask = None  # (n_matches,) bool once a pose was attempted

        if n_matches < min_matches:
            status = f"INSUFFICIENT MATCHES ({n_matches}/{min_matches})"
            if verbose:
                print(f"Frame {frame_count}: {status}")
        else:
            flow = mk2 - mk1
            rms_flow = float(np.sqrt(np.mean(np.sum(flow ** 2, axis=1))))
            if rms_flow < min_motion_pixels:
                # Stationary: let slow motion accumulate; force-refresh the
                # reference frame once it ages out.
                ref_age += 1
                status = f"NO MOTION (rms={rms_flow:.2f}px, age={ref_age})"
                if verbose:
                    print(f"Frame {frame_count}: {status}")
                if ref_age >= max_reference_age:
                    prev_image, prev_feats = curr_image, curr_feats
                    ref_age = 0
                    if verbose:
                        print("  -> reference frame forced update (age limit)")
            else:
                if has_essential:
                    r, t, inlier_mask = recover_pose(e, mk1, mk2, intrinsics)
                else:
                    r, t, inlier_mask = estimate_pose_ransac(
                        mk1, mk2, intrinsics, ransac_threshold=ransac_threshold)
                last_inlier_mask = (np.asarray(inlier_mask).astype(bool)
                                    if inlier_mask is not None else None)
                n_inliers = int(inlier_mask.sum())
                total_inliers += n_inliers
                ratio = n_inliers / n_matches
                if r is None or n_inliers < min_matches or ratio < min_inlier_ratio:
                    status = (f"POSE ESTIMATION FAILED "
                              f"(inliers={n_inliers}, ratio={ratio:.0%})")
                    if verbose:
                        print(f"Frame {frame_count}: {status}")
                    ref_age += 1
                else:
                    trajectory.add_relative_pose(r, t)
                    pose_updated = True
                    prev_image, prev_feats = curr_image, curr_feats
                    ref_age = 0
                    if verbose and processed % 10 == 0:
                        fps = processed / (time.time() - t_start - captured())
                        print(f"Frame {frame_count}/{reader.total_frames}: "
                              f"matches={n_matches}, inliers={n_inliers}, "
                              f"position={trajectory.get_current_position()}, "
                              f"fps={fps:.1f}")

        if display:
            import cv2

            from ..utils import draw_vo_overlay

            info = draw_vo_overlay(
                curr_frame, trajectory, frame_count, n_matches, n_inliers,
                mk2, last_inlier_mask, pose_updated, status,
                model_width, model_height)
            cv2.imshow("Visual Odometry", info)
            key = cv2.waitKey(1) & 0xFF
            if key == ord("q"):
                break
            if key == ord("s"):
                path = f"trajectory_{int(time.time())}.npz"
                trajectory.save_to_file(path)
                print(f"trajectory saved to {path}")

    elapsed, capture_s = time.time() - t_start, captured()
    if verbose:
        print("\nProcessing complete!")
        print(f"Total frames: {frame_count}")
        print(f"Processed frames: {processed}")
        print(f"Trajectory length: {len(trajectory)} poses")
        print(f"Average matches: {total_matches / max(1, processed):.1f}")
        print(f"Average inliers: {total_inliers / max(1, len(trajectory) - 1):.1f}")
        print(f"Total distance: {trajectory.get_trajectory_length():.2f} meters")
        print(f"Processing time: {elapsed:.2f} s "
              f"({processed / max(elapsed - capture_s, 1e-9):.1f} fps without the "
              f"{capture_s:.2f} s of CUDA-graph capture)")
    return trajectory


def build_vo_matcher(name: str, cfg, streaming: bool, device):
    """``(extract_fn, match_fn)`` of the VO loop for pipeline ``name`` (a
    ``_extraction`` suffix is ignored): the streaming split with mutual-NN
    extraction where the model has one and ``streaming`` is set (else
    ``extract_fn`` is None and ``match_fn`` the two-image module with
    mutual-NN extraction). Each is ``models.jit`` of its module, as the JAX
    CLI jits its halves: on the card one CUDA graph per call, its first call
    a capture (``.module`` is the eager module)."""
    base = name.removesuffix("_extraction")
    if streaming and models.supports_streaming(base):
        extract, match = models.build_streaming(base + "_extraction", cfg, device=device)
        return models.jit(extract), models.jit(match)
    return None, models.jit(models.with_match_extraction(models.build(base, cfg, device=device)))


def _capture_seconds(*fns) -> float:
    """Host seconds the jitted ``fns`` spent capturing CUDA graphs so far."""
    return sum(getattr(f, "capture_seconds", 0.0) for f in fns if f is not None)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="visual odometry on the PyTorch port")
    p.add_argument("--model", "-m",
                   default="shi_tomasi_angle_sparse_bad_sinkhorn",
                   help=f"matcher pipeline; one of {models.names()}")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--input", "-i",
                     help="video file, image directory, or 'camera'")
    src.add_argument("--video", "-v", help="input video file path")
    src.add_argument("--image-dir", "-d", help="input image directory path")
    src.add_argument("--camera", "-c", type=int, default=None,
                     help="webcam device ID")
    p.add_argument("--camera-type", "--camera-backend", default="opencv",
                   choices=["opencv", "realsense", "orbbec", "oak"],
                   dest="camera_type")
    p.add_argument("--camera-id", type=int, default=0)
    p.add_argument("--camera-width", type=int, default=640,
                   help="camera capture resolution width")
    p.add_argument("--camera-height", type=int, default=480)
    p.add_argument("--camera-fps", type=int, default=30)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--fx", type=float, default=None)
    p.add_argument("--fy", type=float, default=None)
    p.add_argument("--cx", type=float, default=None)
    p.add_argument("--cy", type=float, default=None)
    p.add_argument("--match-threshold", type=float, default=0.1)
    p.add_argument("--ransac-threshold", type=float, default=1.0)
    p.add_argument("--essential-ransac", type=int, default=0,
                   help="in-graph vectorized RANSAC hypothesis count for "
                        "essential-matrix models (0 = the soft weighted LS "
                        "solve)")
    p.add_argument("--essential-irls", type=int, default=0,
                   help="fixed-iteration IRLS steps for the in-graph "
                        "essential solve (with --essential-ransac: polish "
                        "iterations after the inlier refit)")
    p.add_argument("--no-streaming", dest="streaming", action="store_false",
                   help="run the full two-image matcher per frame instead of "
                        "the feature-cached streaming split (same outputs)")
    p.add_argument("--max-matches", type=int, default=100)
    p.add_argument("--min-matches", type=int, default=20)
    p.add_argument("--min-inlier-ratio", type=float, default=0.5)
    p.add_argument("--min-motion-pixels", type=float, default=1.0)
    p.add_argument("--max-reference-age", type=int, default=30)
    p.add_argument("--skip-frames", type=int, default=1)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--output", "-o", "--save-trajectory", default=None,
                   dest="output", help="trajectory .npz path")
    p.add_argument("--plot", "--save-plot", default=None, dest="plot",
                   help="trajectory plot .png path")
    p.add_argument("--plot-3d", action="store_true",
                   help="3D trajectory plot instead of 2D")
    p.add_argument("--display", action="store_true")
    p.add_argument("--quiet", "-q", action="store_true")
    add_device_arg(p)
    args = p.parse_args(argv)
    # Fold the reference-style source aliases into the single source field.
    if args.video is not None:
        args.input = args.video
    elif args.image_dir is not None:
        args.input = args.image_dir
    elif args.camera is not None:
        args.input = "camera"
        args.camera_id = args.camera
    return args


def main(argv=None):
    args = parse_args(argv)
    device = select_device(args.device)

    reader = VideoReader(args.input, args.camera_type, args.camera_id,
                         args.camera_width, args.camera_height,
                         args.camera_fps)

    # Intrinsics: manual flags, camera auto-detect, or a default guess,
    # rescaled to the model resolution.
    intr = None
    if args.fx is not None:
        intr = CameraIntrinsics(args.fx, args.fy or args.fx,
                                args.cx if args.cx is not None else args.width / 2,
                                args.cy if args.cy is not None else args.height / 2,
                                args.width, args.height)
    elif reader.camera is not None:
        detected = reader.camera.get_camera_intrinsics()
        if detected is not None:
            intr = detected.rescaled(args.width, args.height)
    if intr is None:
        intr = CameraIntrinsics(args.width * 0.8, args.width * 0.8,
                                args.width / 2, args.height / 2,
                                args.width, args.height)
        if not args.quiet:
            print(f"Using default intrinsics: {intr.K[0, 0]:.0f} focal length")

    spec = models.get(args.model.removesuffix("_extraction"))
    cfg = spec.defaults.with_(max_matches=args.max_matches,
                              match_threshold=args.match_threshold,
                              essential_ransac_hypotheses=args.essential_ransac,
                              essential_irls_iters=args.essential_irls)
    extract_fn, fn = build_vo_matcher(spec.name, cfg, args.streaming, device)
    try:
        with torch.inference_mode():
            traj = run_visual_odometry(
                fn, reader, intr, args.height, args.width,
                extract_fn=extract_fn, device=device,
                has_essential=spec.takes_k_inv, k_inv=intr.k_inv(),
                match_threshold=args.match_threshold,
                ransac_threshold=args.ransac_threshold,
                max_matches=args.max_matches, min_matches=args.min_matches,
                min_inlier_ratio=args.min_inlier_ratio,
                min_motion_pixels=args.min_motion_pixels,
                max_reference_age=args.max_reference_age,
                skip_frames=args.skip_frames, max_frames=args.max_frames,
                verbose=not args.quiet, display=args.display)
    finally:
        reader.release()

    if args.output:
        traj.save_to_file(args.output)
        print(f"Trajectory saved to {args.output}")
    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        ax = traj.plot_3d() if args.plot_3d else traj.plot_2d()
        ax.figure.savefig(args.plot, dpi=120)
        plt.close(ax.figure)
        print(f"Trajectory plot saved to {args.plot}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
