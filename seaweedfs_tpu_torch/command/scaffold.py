"""`weed scaffold` equivalent: sample TOML configs
(counterpart of seaweedfs_tpu/command/scaffold.py; SeaweedFS
weed/command/scaffold/*.toml templates)."""

TEMPLATES = {
    "filer": """\
# filer.toml — filer metadata store configuration
# search paths: ./ , ~/.seaweedfs-tpu/ , /etc/seaweedfs-tpu/

[sqlite]
enabled = true
dbFile = "./filer.db"

[memory]
enabled = false

[leveldb]
enabled = false
dir = "./filerldb"

[redis]           # also: [redis2] — same live RESP store, redis2 layout
enabled = false
address = "localhost:6379"
password = ""
database = 0

[redis3]          # size-bounded segmented listings for huge directories
enabled = false
address = "localhost:6379"
password = ""

[postgres]        # also: [postgres2] — per-bucket tables
enabled = false
host = "localhost"
port = 5432
user = "postgres"
password = ""
database = "seaweedfs"

[mysql]           # also: [mysql2] — per-bucket tables
enabled = false
host = "localhost"
port = 3306
user = "root"
password = ""
database = "seaweedfs"

[mongodb]
enabled = false
host = "localhost"
port = 27017
database = "seaweedfs"
user = ""         # SCRAM-SHA-256 when set
password = ""

[cassandra]
enabled = false
host = "localhost"
port = 9042
keyspace = "seaweedfs"
username = ""
password = ""

[etcd]
enabled = false
servers = "localhost:2379"

[elastic7]        # also: [elastic]
enabled = false
host = "localhost"
port = 9200
username = ""
password = ""

[arangodb]
enabled = false
host = "localhost"
port = 8529
username = "root"
password = ""
database = "_system"

[tikv]
enabled = false
pdaddrs = "localhost:2379"

[hbase]
enabled = false
# the Thrift2 gateway address (`hbase thrift2 start`); create the
# table once with: create 'seaweedfs', 'meta', 'kv'
zkquorum = "localhost:9090"
table = "seaweedfs"

[ydb]
enabled = false
dsn = "grpc://localhost:2136/local"
prefix = "seaweedfs"

[redis_lua]
enabled = false
address = "localhost:6379"
password = ""
database = 0
""",
    "master": """\
# master.toml
[master.volume_growth]
copy_1 = 7
copy_2 = 6
copy_other = 3

[master.sequencer]
type = "memory"   # or "snowflake"
""",
    "security": """\
# security.toml — searched in ./ , ~/.seaweedfs-tpu/ , /etc/seaweedfs-tpu/
[jwt.signing]
key = ""            # base64 secret; empty disables write JWT
expires_after_seconds = 10

[jwt.signing.read]
key = ""

[guard]
white_list = []     # e.g. ["127.0.0.1", "10.0.0.0/8"]; empty = open

[access]
ui = true

# All gRPC TLS authentications are MUTUAL: when a component section
# carries cert+key and [grpc] carries the shared ca, that component's
# gRPC port requires a client certificate signed by the same ca, and
# plaintext clients are rejected. Certs must cover the host names in
# their SANs. Empty values (the default) keep plaintext.
[grpc]
ca = ""
allowed_wildcard_domain = ""   # e.g. ".mycompany.com"

[grpc.master]
cert = ""
key = ""
allowed_commonNames = ""       # comma-separated CNs

[grpc.volume]
cert = ""
key = ""
allowed_commonNames = ""

[grpc.filer]
cert = ""
key = ""
allowed_commonNames = ""

[grpc.msg_broker]
cert = ""
key = ""

[grpc.s3]
cert = ""
key = ""
allowed_commonNames = ""       # gates Configure: it replaces ALL identities

[grpc.client]
cert = ""
key = ""
""",
    "shell": """\
# shell.toml
[cluster]
default = "localhost:9333"
""",
}


def print_scaffold(name: str) -> None:
    print(TEMPLATES[name])
