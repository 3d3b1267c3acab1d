"""ROS bridge (optional): maps the reference's rebvo_ros nodelet surface
(reference ros/src/rebvo_ros/src/rebvo_nodelet.cpp:36-250) onto
VOSystem's push API, with full OUTPUT parity:

    image topic  -> VOSystem.process_frame   (requestCustomCamBuffer role)
    imu topic    -> VOSystem.pushIMU
    output       -> EdgeMap-equivalent message (per-keyline gradient /
                    image + focal-plane position / inverse depth +
                    uncertainty / match ids / chain links — the fields of
                    msg/Keyline.msg), PointCloud2 of the unprojected
                    keylines (rebvo_nodelet.cpp:159-214), PoseStamped,
                    and the map->cam TF transform (:221-241)

The message-shaping is pure numpy (`build_edgemap_dict`,
`build_pointcloud2`, `build_tf`) so it is testable without ROS; rospy
import happens only inside `make_node`. In environments without ROS
use io.telemetry for streaming instead.

PyTorch counterpart of rebvo_tpu/apps/ros_bridge.py: the builders take
the port's KeylineMap (tensors on any device, moved to the host in one
transfer, or numpy) and give the JAX package's arrays; `make_node`
builds the port's VOSystem.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Tuple

import numpy as np

from rebvo_tpu_torch.frontend.state import keylines_to_host

_FIELDS = ("valid", "x", "y", "gx", "gy", "px", "py", "rho", "s_rho",
           "m_id", "m_num", "p_id", "n_id")


def _host(klm) -> SimpleNamespace:
    """The fields the messages read, as numpy (tensors: one transfer)."""
    return SimpleNamespace(**keylines_to_host(klm, _FIELDS))


def build_edgemap_dict(klm, K_scale: float) -> dict:
    """The EdgeMap.msg payload (msg/Keyline.msg fields) as arrays over
    the valid keylines."""
    klm = _host(klm)
    valid = np.asarray(klm.valid)
    sel = np.nonzero(valid)[0]
    return dict(
        KlGrad=np.stack([np.asarray(klm.gx)[sel],
                         np.asarray(klm.gy)[sel]], 1).astype(np.float32),
        KlImgPos=np.stack([np.asarray(klm.x)[sel],
                           np.asarray(klm.y)[sel]], 1).astype(np.float32),
        invDepth=np.asarray(klm.rho)[sel].astype(np.float64),
        invDepthS=np.asarray(klm.s_rho)[sel].astype(np.float64),
        KlFocPos=np.stack([np.asarray(klm.px)[sel],
                           np.asarray(klm.py)[sel]], 1).astype(np.float32),
        KlMatchID=np.asarray(klm.m_id)[sel].astype(np.int32),
        ConsMatch=np.asarray(klm.m_num)[sel].astype(np.int32),
        KlPrevMatchID=np.asarray(klm.p_id)[sel].astype(np.int16),
        KlNextMatchID=np.asarray(klm.n_id)[sel].astype(np.int16),
    )


def unproject_keylines(klm, K_scale: float, zfm: float) -> np.ndarray:
    """3-D points of the valid keylines in the camera frame, metric
    scale applied (unprojectHomCordVec with rho/K,
    rebvo_nodelet.cpp:204-208): X = [px/zfm, py/zfm, 1] * K/rho."""
    klm = _host(klm)
    valid = np.asarray(klm.valid)
    sel = np.nonzero(valid)[0]
    px = np.asarray(klm.px)[sel]
    py = np.asarray(klm.py)[sel]
    rho = np.clip(np.asarray(klm.rho)[sel] / max(float(K_scale), 1e-12),
                  1e-3, 1e3)
    z = 1.0 / rho
    return np.stack([px * z / zfm, py * z / zfm, z], 1).astype(np.float32)


def build_pointcloud2(points: np.ndarray) -> dict:
    """A sensor_msgs/PointCloud2-shaped dict: xyz float32 layout exactly
    as the reference's PointCloud2Modifier 'xyz' (point_step 16,
    fields x/y/z at offsets 0/4/8)."""
    n = points.shape[0]
    step = 16
    data = np.zeros((n, step), np.uint8)
    data[:, 0:12] = points.astype("<f4").view(np.uint8).reshape(n, 12)
    return dict(
        height=1, width=n, is_bigendian=False, is_dense=False,
        point_step=step, row_step=step * n,
        fields=[dict(name="x", offset=0, datatype=7, count=1),
                dict(name="y", offset=4, datatype=7, count=1),
                dict(name="z", offset=8, datatype=7, count=1)],
        data=data.tobytes())


def build_tf(pose_lie: np.ndarray, pos: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray]:
    """map->cam transform as (quaternion xyzw, translation), from the
    Lie pose exactly as the nodelet does (axis-angle -> quaternion,
    rebvo_nodelet.cpp:221-236)."""
    rot = np.asarray(pose_lie, np.float64)
    angle = np.linalg.norm(rot)
    if angle > 0:
        axis = rot / angle
        s = np.sin(angle / 2.0)
        quat = np.asarray([axis[0] * s, axis[1] * s, axis[2] * s,
                           np.cos(angle / 2.0)])
    else:
        quat = np.asarray([0.0, 0.0, 0.0, 1.0])
    return quat, np.asarray(pos, np.float64)


def make_node(params=None, image_topic: str = "/cam0/image_raw",
              imu_topic: str = "/imu0", frame_id_cam: str = "cam",
              frame_id_robot: str = "base_link", device="cuda"):
    try:
        import rospy
        from geometry_msgs.msg import PoseStamped
        from sensor_msgs.msg import Image, Imu, PointCloud2, PointField
        import tf as ros_tf
    except ImportError as e:      # pragma: no cover - no ROS here
        raise RuntimeError(
            "rospy unavailable: the ROS bridge requires a ROS environment; "
            "without one use io.telemetry for streaming instead") from e

    from rebvo_tpu_torch.system import VOSystem

    sys_ = VOSystem(params, device=device)
    pose_pub = rospy.Publisher("rebvo_tpu/pose", PoseStamped, queue_size=2)
    cloud_pub = rospy.Publisher("rebvo_tpu/point_cloud", PointCloud2,
                                queue_size=2)
    # EdgeMap.msg needs the message package built; publish the same
    # payload as a PointCloud2 sidecar with extra fields when the custom
    # message type is unavailable
    try:
        from rebvo_ros.msg import EdgeMap, Keyline   # noqa: F401
        edgemap_pub = rospy.Publisher("rebvo_tpu/edge_map", EdgeMap,
                                      queue_size=2)
    except ImportError:
        EdgeMap = Keyline = None
        edgemap_pub = None
    tf_broad = ros_tf.TransformBroadcaster()

    def on_image(msg: "Image"):
        arr = np.frombuffer(msg.data, np.uint8).reshape(msg.height,
                                                        msg.width, -1)
        gray = arr[..., :3].astype(np.float32).sum(-1) if arr.ndim == 3 \
            else arr.astype(np.float32) * 3.0
        t = msg.header.stamp.to_sec()
        out = sys_.process_frame(gray, t)
        if out is None:
            return

        # PoseStamped
        msg_out = PoseStamped()
        msg_out.header.stamp = msg.header.stamp
        msg_out.header.frame_id = frame_id_cam
        pos = out.nav.Pos.cpu().numpy()
        pose_lie = out.nav.PoseLie.cpu().numpy()
        scale = float(out.nav.scale)
        msg_out.pose.position.x = float(pos[0])
        msg_out.pose.position.y = float(pos[1])
        msg_out.pose.position.z = float(pos[2])
        quat, _ = build_tf(pose_lie, pos)
        (msg_out.pose.orientation.x, msg_out.pose.orientation.y,
         msg_out.pose.orientation.z, msg_out.pose.orientation.w) = quat
        pose_pub.publish(msg_out)

        # PointCloud2 of unprojected keylines
        pts = unproject_keylines(sys_.state.klm, scale,
                                 float(sys_.frontend.cam.zfm))
        pc = build_pointcloud2(pts)
        cloud = PointCloud2()
        cloud.header.stamp = msg.header.stamp
        cloud.header.frame_id = frame_id_cam
        cloud.height = pc["height"]
        cloud.width = pc["width"]
        cloud.fields = [PointField(name=f["name"], offset=f["offset"],
                                   datatype=f["datatype"], count=1)
                        for f in pc["fields"]]
        cloud.is_bigendian = pc["is_bigendian"]
        cloud.point_step = pc["point_step"]
        cloud.row_step = pc["row_step"]
        cloud.is_dense = pc["is_dense"]
        cloud.data = pc["data"]
        cloud_pub.publish(cloud)

        # EdgeMap message (when the msg package is on the path)
        if edgemap_pub is not None:
            em = build_edgemap_dict(sys_.state.klm, scale)
            msg_em = EdgeMap()
            msg_em.header.stamp = msg.header.stamp
            msg_em.header.frame_id = frame_id_cam
            for i in range(em["invDepth"].shape[0]):
                kl = Keyline()
                kl.KlGrad = em["KlGrad"][i].tolist()
                kl.KlImgPos = em["KlImgPos"][i].tolist()
                kl.invDepth = float(em["invDepth"][i])
                kl.invDepthS = float(em["invDepthS"][i])
                kl.KlFocPos = em["KlFocPos"][i].tolist()
                kl.KlMatchID = int(em["KlMatchID"][i])
                kl.ConsMatch = int(em["ConsMatch"][i])
                kl.KlPrevMatchID = int(em["KlPrevMatchID"][i])
                kl.KlNextMatchID = int(em["KlNextMatchID"][i])
                msg_em.Keylines.append(kl)
            edgemap_pub.publish(msg_em)

        # TF map->cam
        quat, trans = build_tf(pose_lie, pos)
        tf_broad.sendTransform(trans.tolist(), quat.tolist(),
                               msg.header.stamp, frame_id_cam, "map")

    def on_imu(msg: "Imu"):
        sys_.pushIMU(msg.header.stamp.to_sec(),
                     [msg.angular_velocity.x, msg.angular_velocity.y,
                      msg.angular_velocity.z],
                     [msg.linear_acceleration.x, msg.linear_acceleration.y,
                      msg.linear_acceleration.z])

    rospy.Subscriber(image_topic, Image, on_image, queue_size=2)
    rospy.Subscriber(imu_topic, Imu, on_imu, queue_size=200)
    return sys_
