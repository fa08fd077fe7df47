"""An in-process stand-in, for the tests and ``chip_smoke.py``, for the
three ROS modules :class:`~pix2pose_torch.serving.service.RosAdapter`
imports (``rospy``, ``ros_numpy``, ``sensor_msgs.msg``), so the adapter
runs without a ROS installation: a message bus whose subscribers are
called synchronously, publishers that record what they publish, and a
``rospy.spin`` that plays a script of ``(topic, array)`` messages in
order.

    bus = LoopbackRos([(cfg.depth_topic, depth_mm), (cfg.rgb_topic, rgb)])
    with bus.installed():
        RosAdapter(service).spin()
    bus.published["/pix2pose/object_pose"]   # the published arrays

A message delivered to a topic nobody subscribes to at that moment is
counted in ``dropped``, as ROS drops it.
"""

from __future__ import annotations

import contextlib
import sys
import types


class Image:
    """``sensor_msgs.msg.Image`` reduced to its array and encoding."""

    def __init__(self, data, encoding: str = ""):
        self.data, self.encoding = data, encoding


class LoopbackRos:
    def __init__(self, script=()):
        self.script = list(script)
        self.subscribers: dict = {}    # topic -> [subscription, ...]
        self.published: dict = {}      # topic -> [array, ...]
        self.dropped: dict = {}        # topic -> count
        self.subscribe_log: list = []  # topics in subscription order
        self.node = None

    def deliver(self, topic: str, data):
        """Hand ``data`` to the topic's current subscribers now."""
        subs = list(self.subscribers.get(topic, ()))
        if not subs:
            self.dropped[topic] = self.dropped.get(topic, 0) + 1
        for sub in subs:
            sub.callback(Image(data))

    def _modules(self) -> dict:
        bus = self

        class Subscriber:
            def __init__(self, topic, msg_type, callback, queue_size=None):
                self.topic, self.callback = topic, callback
                bus.subscribers.setdefault(topic, []).append(self)
                bus.subscribe_log.append(topic)

            def unregister(self):
                bus.subscribers[self.topic].remove(self)

        class Publisher:
            def __init__(self, topic, msg_type, queue_size=None):
                self.topic = topic
                bus.published.setdefault(topic, [])

            def publish(self, msg):
                bus.published[self.topic].append(msg.data)

        def init_node(name, **_):
            bus.node = name

        def spin():
            for topic, data in bus.script:
                bus.deliver(topic, data)

        rospy = types.ModuleType("rospy")
        rospy.Subscriber, rospy.Publisher = Subscriber, Publisher
        rospy.init_node, rospy.spin = init_node, spin
        ros_numpy = types.ModuleType("ros_numpy")
        ros_numpy.numpify = lambda msg: msg.data
        ros_numpy.msgify = lambda cls, arr, encoding="": cls(arr, encoding)
        sensor_msgs = types.ModuleType("sensor_msgs")
        msg = types.ModuleType("sensor_msgs.msg")
        msg.Image = Image
        sensor_msgs.msg = msg
        return {"rospy": rospy, "ros_numpy": ros_numpy,
                "sensor_msgs": sensor_msgs, "sensor_msgs.msg": msg}

    @contextlib.contextmanager
    def installed(self):
        """The three modules in ``sys.modules`` while the block runs."""
        mods = self._modules()
        saved = {k: sys.modules.get(k) for k in mods}
        sys.modules.update(mods)
        try:
            yield self
        finally:
            for k, v in saved.items():
                if v is None:
                    sys.modules.pop(k, None)
                else:
                    sys.modules[k] = v
