"""Camera hardware-abstraction layer for the VO app.

Counterpart of `pytorch_model/vo/camera.py:18-1009`: a ``BaseCamera`` ABC, a
fully functional OpenCV webcam/video backend, and RGBD backends (RealSense,
Orbbec, OAK) gated behind their optional vendor SDKs — the reference likewise
ships them commented out of requirements (`requirements.txt:12-15`). Each RGBD
backend exposes ``read_rgbd`` and intrinsics auto-detection so the VO CLI can
rescale them to the model resolution.
A copy of ``onnx_image_processing_tpu/vo/camera.py``.
"""

from __future__ import annotations

import logging
from abc import ABC, abstractmethod

import numpy as np

from .pose import CameraIntrinsics

logger = logging.getLogger(__name__)


class BaseCamera(ABC):
    """Minimal camera interface (parity: `vo/camera.py:18-82`)."""

    @abstractmethod
    def open(self) -> bool:
        """Open the device; True on success."""

    @abstractmethod
    def read(self):
        """Return (ok, frame BGR uint8 | None)."""

    @abstractmethod
    def release(self) -> None:
        """Close the device."""

    @abstractmethod
    def is_opened(self) -> bool:
        """Whether the device is open."""

    @abstractmethod
    def get_fps(self) -> float:
        """Nominal frames per second."""

    @abstractmethod
    def get_resolution(self):
        """(width, height)."""

    def read_rgbd(self):
        """(ok, color, depth) — depth backends override; color-only cameras
        return depth=None."""
        ok, frame = self.read()
        return ok, frame, None

    def get_camera_intrinsics(self) -> CameraIntrinsics | None:
        """Auto-detected intrinsics, if the backend provides them."""
        return None


class OpenCVCamera(BaseCamera):
    """cv2.VideoCapture webcam / video-file backend (`vo/camera.py:84-156`)."""

    def __init__(self, device_id: int | str = 0):
        self.device_id = device_id
        self._cap = None

    def open(self) -> bool:
        import cv2

        self._cap = cv2.VideoCapture(self.device_id)
        if not self._cap.isOpened():
            logger.error("failed to open OpenCV device %r", self.device_id)
            return False
        return True

    def read(self):
        if self._cap is None:
            return False, None
        ok, frame = self._cap.read()
        return (ok, frame if ok else None)

    def release(self) -> None:
        if self._cap is not None:
            self._cap.release()
            self._cap = None

    def is_opened(self) -> bool:
        return self._cap is not None and self._cap.isOpened()

    def get_fps(self) -> float:
        import cv2

        if self._cap is None:
            return 0.0
        return float(self._cap.get(cv2.CAP_PROP_FPS)) or 30.0

    def get_resolution(self):
        import cv2

        if self._cap is None:
            return (0, 0)
        return (int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))

    def set_resolution(self, width: int, height: int) -> bool:
        import cv2

        if self._cap is None:
            return False
        self._cap.set(cv2.CAP_PROP_FRAME_WIDTH, width)
        self._cap.set(cv2.CAP_PROP_FRAME_HEIGHT, height)
        return self.get_resolution() == (width, height)

    def __repr__(self):
        return f"OpenCVCamera(device_id={self.device_id!r})"


class RealSenseCamera(BaseCamera):
    """Intel RealSense RGBD backend (`vo/camera.py:158-379`); needs
    ``pyrealsense2``."""

    def __init__(self, width: int = 640, height: int = 480, fps: int = 30,
                 align_to_color: bool = True):
        try:
            import pyrealsense2 as rs
        except ImportError as err:
            raise ImportError(
                "RealSenseCamera requires pyrealsense2 (not installed)") from err
        self._rs = rs
        self.width, self.height, self.fps = width, height, fps
        self.align_to_color = align_to_color
        self._pipeline = None
        self._align = None
        self._intrinsics = None

    def open(self) -> bool:
        rs = self._rs
        self._pipeline = rs.pipeline()
        cfg = rs.config()
        cfg.enable_stream(rs.stream.color, self.width, self.height,
                          rs.format.bgr8, self.fps)
        cfg.enable_stream(rs.stream.depth, self.width, self.height,
                          rs.format.z16, self.fps)
        try:
            profile = self._pipeline.start(cfg)
        except RuntimeError as err:
            logger.error("RealSense open failed: %s", err)
            self._pipeline = None
            return False
        if self.align_to_color:
            self._align = rs.align(rs.stream.color)
        stream = profile.get_stream(rs.stream.color).as_video_stream_profile()
        i = stream.get_intrinsics()
        self._intrinsics = CameraIntrinsics(i.fx, i.fy, i.ppx, i.ppy,
                                            i.width, i.height)
        return True

    def read(self):
        ok, color, _ = self.read_rgbd()
        return ok, color

    def read_rgbd(self):
        if self._pipeline is None:
            return False, None, None
        frames = self._pipeline.wait_for_frames()
        if self._align is not None:
            frames = self._align.process(frames)
        color = frames.get_color_frame()
        depth = frames.get_depth_frame()
        if not color:
            return False, None, None
        color_np = np.asanyarray(color.get_data())
        depth_np = np.asanyarray(depth.get_data()) if depth else None
        return True, color_np, depth_np

    def get_camera_intrinsics(self):
        return self._intrinsics

    def release(self) -> None:
        if self._pipeline is not None:
            self._pipeline.stop()
            self._pipeline = None

    def is_opened(self) -> bool:
        return self._pipeline is not None

    def get_fps(self) -> float:
        return float(self.fps)

    def get_resolution(self):
        return (self.width, self.height)


class OrbbecCamera(BaseCamera):
    """Orbbec RGBD backend (`vo/camera.py:381-657`); needs ``pyorbbecsdk``."""

    def __init__(self, width: int = 640, height: int = 480, fps: int = 30):
        try:
            import pyorbbecsdk as ob
        except ImportError as err:
            raise ImportError(
                "OrbbecCamera requires pyorbbecsdk (not installed)") from err
        self._ob = ob
        self.width, self.height, self.fps = width, height, fps
        self._pipeline = None
        self._intrinsics = None

    def open(self) -> bool:
        ob = self._ob
        try:
            self._pipeline = ob.Pipeline()
            cfg = ob.Config()
            profiles = self._pipeline.get_stream_profile_list(
                ob.OBSensorType.COLOR_SENSOR)
            color = profiles.get_video_stream_profile(
                self.width, self.height, ob.OBFormat.RGB, self.fps)
            cfg.enable_stream(color)
            dprofiles = self._pipeline.get_stream_profile_list(
                ob.OBSensorType.DEPTH_SENSOR)
            cfg.enable_stream(dprofiles.get_default_video_stream_profile())
            self._pipeline.start(cfg)
            intr = color.get_intrinsic()
            self._intrinsics = CameraIntrinsics(intr.fx, intr.fy, intr.cx,
                                                intr.cy, self.width, self.height)
            return True
        except Exception as err:  # SDK raises its own error types
            logger.error("Orbbec open failed: %s", err)
            self._pipeline = None
            return False

    def read(self):
        ok, color, _ = self.read_rgbd()
        return ok, color

    def read_rgbd(self):
        if self._pipeline is None:
            return False, None, None
        frames = self._pipeline.wait_for_frames(100)
        if frames is None:
            return False, None, None
        color = frames.get_color_frame()
        depth = frames.get_depth_frame()
        if color is None:
            return False, None, None
        h, w = color.get_height(), color.get_width()
        color_np = np.frombuffer(color.get_data(), np.uint8).reshape(h, w, 3)
        color_np = color_np[:, :, ::-1].copy()  # RGB -> BGR
        depth_np = None
        if depth is not None:
            depth_np = np.frombuffer(depth.get_data(), np.uint16).reshape(
                depth.get_height(), depth.get_width()).copy()
        return True, color_np, depth_np

    def get_camera_intrinsics(self):
        return self._intrinsics

    def release(self) -> None:
        if self._pipeline is not None:
            self._pipeline.stop()
            self._pipeline = None

    def is_opened(self) -> bool:
        return self._pipeline is not None

    def get_fps(self) -> float:
        return float(self.fps)

    def get_resolution(self):
        return (self.width, self.height)


class OAKCamera(BaseCamera):
    """Luxonis OAK RGBD backend (`vo/camera.py:659-922`); needs ``depthai``."""

    def __init__(self, width: int = 640, height: int = 480, fps: int = 30):
        try:
            import depthai as dai
        except ImportError as err:
            raise ImportError("OAKCamera requires depthai (not installed)") from err
        self._dai = dai
        self.width, self.height, self.fps = width, height, fps
        self._device = None
        self._color_q = None
        self._depth_q = None
        self._intrinsics = None

    def open(self) -> bool:
        dai = self._dai
        try:
            pipeline = dai.Pipeline()
            cam = pipeline.create(dai.node.ColorCamera)
            cam.setPreviewSize(self.width, self.height)
            cam.setFps(self.fps)
            cam.setColorOrder(dai.ColorCameraProperties.ColorOrder.BGR)
            xout = pipeline.create(dai.node.XLinkOut)
            xout.setStreamName("color")
            cam.preview.link(xout.input)

            left = pipeline.create(dai.node.MonoCamera)
            right = pipeline.create(dai.node.MonoCamera)
            left.setBoardSocket(dai.CameraBoardSocket.CAM_B)
            right.setBoardSocket(dai.CameraBoardSocket.CAM_C)
            stereo = pipeline.create(dai.node.StereoDepth)
            stereo.setDepthAlign(dai.CameraBoardSocket.CAM_A)
            left.out.link(stereo.left)
            right.out.link(stereo.right)
            xout_d = pipeline.create(dai.node.XLinkOut)
            xout_d.setStreamName("depth")
            stereo.depth.link(xout_d.input)

            self._device = dai.Device(pipeline)
            self._color_q = self._device.getOutputQueue("color", 4, False)
            self._depth_q = self._device.getOutputQueue("depth", 4, False)
            calib = self._device.readCalibration()
            m = np.array(calib.getCameraIntrinsics(
                dai.CameraBoardSocket.CAM_A, self.width, self.height))
            self._intrinsics = CameraIntrinsics(m[0, 0], m[1, 1], m[0, 2],
                                                m[1, 2], self.width, self.height)
            return True
        except Exception as err:
            logger.error("OAK open failed: %s", err)
            self._device = None
            return False

    def read(self):
        ok, color, _ = self.read_rgbd()
        return ok, color

    def read_rgbd(self):
        if self._device is None:
            return False, None, None
        color = self._color_q.get().getCvFrame()
        depth = self._depth_q.tryGet()
        depth_np = depth.getFrame() if depth is not None else None
        return True, color, depth_np

    def get_camera_intrinsics(self):
        return self._intrinsics

    def release(self) -> None:
        if self._device is not None:
            self._device.close()
            self._device = None

    def is_opened(self) -> bool:
        return self._device is not None

    def get_fps(self) -> float:
        return float(self.fps)

    def get_resolution(self):
        return (self.width, self.height)


def create_camera(camera_type: str = "opencv", **kwargs) -> BaseCamera:
    """Factory (parity: `vo/camera.py:924-1009`).

    Args:
        camera_type: 'opencv' | 'realsense' | 'orbbec' | 'oak'.
        kwargs: backend constructor arguments.
    """
    backends = {
        "opencv": OpenCVCamera,
        "realsense": RealSenseCamera,
        "orbbec": OrbbecCamera,
        "oak": OAKCamera,
    }
    key = camera_type.lower()
    if key not in backends:
        raise ValueError(
            f"unknown camera type {camera_type!r}; choose from {sorted(backends)}")
    return backends[key](**kwargs)
