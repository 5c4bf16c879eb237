"""Message-log bus: the framework's Kafka-equivalent data plane (the port's
copy of oryx_tpu/bus).

Partitioned append-only topics, consumer-group offsets, replay from
earliest and blocking iteration, behind one URI scheme:

    mem://<name>    in-process broker (tests)
    file://<dir>    durable log segments on a shared filesystem, safe for
                    multi-process producers/consumers (the native
                    appender when liboryxbus.so builds, else pure Python)
    kafka://h:p,..  a Kafka cluster, over the wire protocol (bus/kafka.py)
"""

from oryx_tpu_torch.bus.api import KeyMessage, TopicProducer, ConsumeDataIterator
from oryx_tpu_torch.bus.broker import Broker, get_broker, topics as topic_admin
