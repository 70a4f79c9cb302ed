# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: master.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0cmaster.proto\x12\tmaster_pb\"\xca\x05\n\tHeartbeat\x12\n\n\x02ip\x18\x01 \x01(\t\x12\x0c\n\x04port\x18\x02 \x01(\r\x12\x12\n\npublic_url\x18\x03 \x01(\t\x12\x14\n\x0cmax_file_key\x18\x05 \x01(\x04\x12\x13\n\x0b\x64\x61ta_center\x18\x06 \x01(\t\x12\x0c\n\x04rack\x18\x07 \x01(\t\x12\x12\n\nadmin_port\x18\x08 \x01(\r\x12\x34\n\x07volumes\x18\t \x03(\x0b\x32#.master_pb.VolumeInformationMessage\x12=\n\x0bnew_volumes\x18\n \x03(\x0b\x32(.master_pb.VolumeShortInformationMessage\x12\x41\n\x0f\x64\x65leted_volumes\x18\x0b \x03(\x0b\x32(.master_pb.VolumeShortInformationMessage\x12\x16\n\x0ehas_no_volumes\x18\x0c \x01(\x08\x12=\n\tec_shards\x18\x10 \x03(\x0b\x32*.master_pb.VolumeEcShardInformationMessage\x12\x41\n\rnew_ec_shards\x18\x11 \x03(\x0b\x32*.master_pb.VolumeEcShardInformationMessage\x12\x45\n\x11\x64\x65leted_ec_shards\x18\x12 \x03(\x0b\x32*.master_pb.VolumeEcShardInformationMessage\x12\x18\n\x10has_no_ec_shards\x18\x13 \x01(\x08\x12\x44\n\x11max_volume_counts\x18\x04 \x03(\x0b\x32).master_pb.Heartbeat.MaxVolumeCountsEntry\x12\x11\n\tgrpc_port\x18\x14 \x01(\r\x1a\x36\n\x14MaxVolumeCountsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\r:\x02\x38\x01\"\xae\x01\n\x11HeartbeatResponse\x12\x19\n\x11volume_size_limit\x18\x01 \x01(\x04\x12\x0e\n\x06leader\x18\x02 \x01(\t\x12\x17\n\x0fmetrics_address\x18\x03 \x01(\t\x12 \n\x18metrics_interval_seconds\x18\x04 \x01(\r\x12\x33\n\x10storage_backends\x18\x05 \x03(\x0b\x32\x19.master_pb.StorageBackend\"\xdc\x02\n\x18VolumeInformationMessage\x12\n\n\x02id\x18\x01 \x01(\r\x12\x0c\n\x04size\x18\x02 \x01(\x04\x12\x12\n\ncollection\x18\x03 \x01(\t\x12\x12\n\nfile_count\x18\x04 \x01(\x04\x12\x14\n\x0c\x64\x65lete_count\x18\x05 \x01(\x04\x12\x1a\n\x12\x64\x65leted_byte_count\x18\x06 \x01(\x04\x12\x11\n\tread_only\x18\x07 \x01(\x08\x12\x19\n\x11replica_placement\x18\x08 \x01(\r\x12\x0f\n\x07version\x18\t \x01(\r\x12\x0b\n\x03ttl\x18\n \x01(\r\x12\x18\n\x10\x63ompact_revision\x18\x0b \x01(\r\x12\x1a\n\x12modified_at_second\x18\x0c \x01(\x03\x12\x1b\n\x13remote_storage_name\x18\r \x01(\t\x12\x1a\n\x12remote_storage_key\x18\x0e \x01(\t\x12\x11\n\tdisk_type\x18\x0f \x01(\t\"\x8b\x01\n\x1dVolumeShortInformationMessage\x12\n\n\x02id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x03 \x01(\t\x12\x19\n\x11replica_placement\x18\x08 \x01(\r\x12\x0f\n\x07version\x18\t \x01(\r\x12\x0b\n\x03ttl\x18\n \x01(\r\x12\x11\n\tdisk_type\x18\x0f \x01(\t\"k\n\x1fVolumeEcShardInformationMessage\x12\n\n\x02id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x15\n\rec_index_bits\x18\x03 \x01(\r\x12\x11\n\tdisk_type\x18\x04 \x01(\t\"\x9c\x01\n\x0eStorageBackend\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\n\n\x02id\x18\x02 \x01(\t\x12=\n\nproperties\x18\x03 \x03(\x0b\x32).master_pb.StorageBackend.PropertiesEntry\x1a\x31\n\x0fPropertiesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"i\n\x14KeepConnectedRequest\x12\x13\n\x0b\x63lient_type\x18\x01 \x01(\t\x12\x16\n\x0e\x63lient_address\x18\x03 \x01(\t\x12\x0f\n\x07version\x18\x04 \x01(\t\x12\x13\n\x0b\x66iler_group\x18\x05 \x01(\t\"\xbf\x01\n\x0eVolumeLocation\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x12\n\npublic_url\x18\x02 \x01(\t\x12\x10\n\x08new_vids\x18\x03 \x03(\r\x12\x14\n\x0c\x64\x65leted_vids\x18\x04 \x03(\r\x12\x0e\n\x06leader\x18\x05 \x01(\t\x12\x13\n\x0b\x64\x61ta_center\x18\x06 \x01(\t\x12\x11\n\tgrpc_port\x18\x07 \x01(\r\x12\x13\n\x0bnew_ec_vids\x18\x08 \x03(\r\x12\x17\n\x0f\x64\x65leted_ec_vids\x18\t \x03(\r\"o\n\x11\x43lusterNodeUpdate\x12\x11\n\tnode_type\x18\x01 \x01(\t\x12\x0f\n\x07\x61\x64\x64ress\x18\x02 \x01(\t\x12\x11\n\tis_leader\x18\x03 \x01(\x08\x12\x0e\n\x06is_add\x18\x04 \x01(\x08\x12\x13\n\x0b\x66iler_group\x18\x05 \x01(\t\"\x86\x01\n\x15KeepConnectedResponse\x12\x32\n\x0fvolume_location\x18\x01 \x01(\x0b\x32\x19.master_pb.VolumeLocation\x12\x39\n\x13\x63luster_node_update\x18\x02 \x01(\x0b\x32\x1c.master_pb.ClusterNodeUpdate\"E\n\x13LookupVolumeRequest\x12\x1a\n\x12volume_or_file_ids\x18\x01 \x03(\t\x12\x12\n\ncollection\x18\x02 \x01(\t\"\xd9\x01\n\x14LookupVolumeResponse\x12M\n\x13volume_id_locations\x18\x01 \x03(\x0b\x32\x30.master_pb.LookupVolumeResponse.VolumeIdLocation\x1ar\n\x10VolumeIdLocation\x12\x19\n\x11volume_or_file_id\x18\x01 \x01(\t\x12&\n\tlocations\x18\x02 \x03(\x0b\x32\x13.master_pb.Location\x12\r\n\x05\x65rror\x18\x03 \x01(\t\x12\x0c\n\x04\x61uth\x18\x04 \x01(\t\"S\n\x08Location\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x12\n\npublic_url\x18\x02 \x01(\t\x12\x11\n\tgrpc_port\x18\x03 \x01(\r\x12\x13\n\x0b\x64\x61ta_center\x18\x04 \x01(\t\"\xdc\x01\n\rAssignRequest\x12\r\n\x05\x63ount\x18\x01 \x01(\x04\x12\x13\n\x0breplication\x18\x02 \x01(\t\x12\x12\n\ncollection\x18\x03 \x01(\t\x12\x0b\n\x03ttl\x18\x04 \x01(\t\x12\x13\n\x0b\x64\x61ta_center\x18\x05 \x01(\t\x12\x0c\n\x04rack\x18\x06 \x01(\t\x12\x11\n\tdata_node\x18\x07 \x01(\t\x12\x1e\n\x16memory_map_max_size_mb\x18\x08 \x01(\r\x12\x1d\n\x15writable_volume_count\x18\t \x01(\r\x12\x11\n\tdisk_type\x18\n \x01(\t\"\x97\x01\n\x0e\x41ssignResponse\x12\x0b\n\x03\x66id\x18\x01 \x01(\t\x12\r\n\x05\x63ount\x18\x04 \x01(\x04\x12\r\n\x05\x65rror\x18\x05 \x01(\t\x12\x0c\n\x04\x61uth\x18\x06 \x01(\t\x12%\n\x08replicas\x18\x07 \x03(\x0b\x32\x13.master_pb.Location\x12%\n\x08location\x18\x08 \x01(\x0b\x32\x13.master_pb.Location\"\\\n\x11StatisticsRequest\x12\x13\n\x0breplication\x18\x01 \x01(\t\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x0b\n\x03ttl\x18\x03 \x01(\t\x12\x11\n\tdisk_type\x18\x04 \x01(\t\"O\n\x12StatisticsResponse\x12\x12\n\ntotal_size\x18\x04 \x01(\x04\x12\x11\n\tused_size\x18\x05 \x01(\x04\x12\x12\n\nfile_count\x18\x06 \x01(\x04\"\x1a\n\nCollection\x12\x0c\n\x04name\x18\x01 \x01(\t\"S\n\x15\x43ollectionListRequest\x12\x1e\n\x16include_normal_volumes\x18\x01 \x01(\x08\x12\x1a\n\x12include_ec_volumes\x18\x02 \x01(\x08\"D\n\x16\x43ollectionListResponse\x12*\n\x0b\x63ollections\x18\x01 \x03(\x0b\x32\x15.master_pb.Collection\"\'\n\x17\x43ollectionDeleteRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\"\x1a\n\x18\x43ollectionDeleteResponse\"\x9c\x02\n\x08\x44iskInfo\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\x14\n\x0cvolume_count\x18\x02 \x01(\x03\x12\x18\n\x10max_volume_count\x18\x03 \x01(\x03\x12\x19\n\x11\x66ree_volume_count\x18\x04 \x01(\x03\x12\x1b\n\x13\x61\x63tive_volume_count\x18\x05 \x01(\x03\x12\x39\n\x0cvolume_infos\x18\x06 \x03(\x0b\x32#.master_pb.VolumeInformationMessage\x12\x42\n\x0e\x65\x63_shard_infos\x18\x07 \x03(\x0b\x32*.master_pb.VolumeEcShardInformationMessage\x12\x1b\n\x13remote_volume_count\x18\x08 \x01(\x03\"\xb0\x01\n\x0c\x44\x61taNodeInfo\x12\n\n\x02id\x18\x01 \x01(\t\x12:\n\ndisk_infos\x18\x02 \x03(\x0b\x32&.master_pb.DataNodeInfo.DiskInfosEntry\x12\x11\n\tgrpc_port\x18\x03 \x01(\r\x1a\x45\n\x0e\x44iskInfosEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\"\n\x05value\x18\x02 \x01(\x0b\x32\x13.master_pb.DiskInfo:\x02\x38\x01\"H\n\x08RackInfo\x12\n\n\x02id\x18\x01 \x01(\t\x12\x30\n\x0f\x64\x61ta_node_infos\x18\x02 \x03(\x0b\x32\x17.master_pb.DataNodeInfo\"E\n\x0e\x44\x61taCenterInfo\x12\n\n\x02id\x18\x01 \x01(\t\x12\'\n\nrack_infos\x18\x02 \x03(\x0b\x32\x13.master_pb.RackInfo\"P\n\x0cTopologyInfo\x12\n\n\x02id\x18\x01 \x01(\t\x12\x34\n\x11\x64\x61ta_center_infos\x18\x02 \x03(\x0b\x32\x19.master_pb.DataCenterInfo\"\x13\n\x11VolumeListRequest\"b\n\x12VolumeListResponse\x12.\n\rtopology_info\x18\x01 \x01(\x0b\x32\x17.master_pb.TopologyInfo\x12\x1c\n\x14volume_size_limit_mb\x18\x02 \x01(\x04\"*\n\x15LookupEcVolumeRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\xcb\x01\n\x16LookupEcVolumeResponse\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12O\n\x12shard_id_locations\x18\x02 \x03(\x0b\x32\x33.master_pb.LookupEcVolumeResponse.EcShardIdLocation\x1aM\n\x11\x45\x63ShardIdLocation\x12\x10\n\x08shard_id\x18\x01 \x01(\r\x12&\n\tlocations\x18\x02 \x03(\x0b\x32\x13.master_pb.Location\"W\n\x13VacuumVolumeRequest\x12\x19\n\x11garbage_threshold\x18\x01 \x01(\x02\x12\x11\n\tvolume_id\x18\x02 \x01(\r\x12\x12\n\ncollection\x18\x03 \x01(\t\"\x16\n\x14VacuumVolumeResponse\"\x16\n\x14\x44isableVacuumRequest\"\x17\n\x15\x44isableVacuumResponse\"\x15\n\x13\x45nableVacuumRequest\"\x16\n\x14\x45nableVacuumResponse\"\xbd\x01\n\x19VolumeMarkReadonlyRequest\x12\n\n\x02ip\x18\x01 \x01(\t\x12\x0c\n\x04port\x18\x02 \x01(\r\x12\x11\n\tvolume_id\x18\x04 \x01(\r\x12\x12\n\ncollection\x18\x05 \x01(\t\x12\x19\n\x11replica_placement\x18\x06 \x01(\r\x12\x0f\n\x07version\x18\x07 \x01(\r\x12\x0b\n\x03ttl\x18\x08 \x01(\r\x12\x11\n\tdisk_type\x18\t \x01(\t\x12\x13\n\x0bis_readonly\x18\n \x01(\x08\"\x1c\n\x1aVolumeMarkReadonlyResponse\"\x1f\n\x1dGetMasterConfigurationRequest\"\xf8\x01\n\x1eGetMasterConfigurationResponse\x12\x17\n\x0fmetrics_address\x18\x01 \x01(\t\x12 \n\x18metrics_interval_seconds\x18\x02 \x01(\r\x12\x33\n\x10storage_backends\x18\x03 \x03(\x0b\x32\x19.master_pb.StorageBackend\x12\x1b\n\x13\x64\x65\x66\x61ult_replication\x18\x04 \x01(\t\x12\x0e\n\x06leader\x18\x05 \x01(\t\x12\x1d\n\x15volume_size_limit_m_b\x18\x06 \x01(\r\x12\x1a\n\x12volume_preallocate\x18\x07 \x01(\x08\"\x85\x01\n\x16LeaseAdminTokenRequest\x12\x16\n\x0eprevious_token\x18\x01 \x01(\x03\x12\x1a\n\x12previous_lock_time\x18\x02 \x01(\x03\x12\x11\n\tlock_name\x18\x03 \x01(\t\x12\x13\n\x0b\x63lient_name\x18\x04 \x01(\t\x12\x0f\n\x07message\x18\x05 \x01(\t\"<\n\x17LeaseAdminTokenResponse\x12\r\n\x05token\x18\x01 \x01(\x03\x12\x12\n\nlock_ts_ns\x18\x02 \x01(\x03\"a\n\x18ReleaseAdminTokenRequest\x12\x16\n\x0eprevious_token\x18\x01 \x01(\x03\x12\x1a\n\x12previous_lock_time\x18\x02 \x01(\x03\x12\x11\n\tlock_name\x18\x03 \x01(\t\"\x1b\n\x19ReleaseAdminTokenResponse\"C\n\x17ListClusterNodesRequest\x12\x13\n\x0b\x63lient_type\x18\x01 \x01(\t\x12\x13\n\x0b\x66iler_group\x18\x02 \x01(\t\"\xe0\x01\n\x18ListClusterNodesResponse\x12\x46\n\rcluster_nodes\x18\x01 \x03(\x0b\x32/.master_pb.ListClusterNodesResponse.ClusterNode\x1a|\n\x0b\x43lusterNode\x12\x0f\n\x07\x61\x64\x64ress\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t\x12\x11\n\tis_leader\x18\x03 \x01(\x08\x12\x15\n\rcreated_at_ns\x18\x04 \x01(\x03\x12\x13\n\x0b\x64\x61ta_center\x18\x05 \x01(\t\x12\x0c\n\x04rack\x18\x06 \x01(\t\"2\n\x0bPingRequest\x12\x0e\n\x06target\x18\x01 \x01(\t\x12\x13\n\x0btarget_type\x18\x02 \x01(\t\"S\n\x0cPingResponse\x12\x15\n\rstart_time_ns\x18\x01 \x01(\x03\x12\x16\n\x0eremote_time_ns\x18\x02 \x01(\x03\x12\x14\n\x0cstop_time_ns\x18\x03 \x01(\x03\"B\n\x14RaftAddServerRequest\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0f\n\x07\x61\x64\x64ress\x18\x02 \x01(\t\x12\r\n\x05voter\x18\x03 \x01(\x08\"\x17\n\x15RaftAddServerResponse\"4\n\x17RaftRemoveServerRequest\x12\n\n\x02id\x18\x01 \x01(\t\x12\r\n\x05\x66orce\x18\x02 \x01(\x08\"\x1a\n\x18RaftRemoveServerResponse\"\x1f\n\x1dRaftListClusterServersRequest\"\xc6\x01\n\x1eRaftListClusterServersResponse\x12Q\n\x0f\x63luster_servers\x18\x01 \x03(\x0b\x32\x38.master_pb.RaftListClusterServersResponse.ClusterServers\x1aQ\n\x0e\x43lusterServers\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0f\n\x07\x61\x64\x64ress\x18\x02 \x01(\t\x12\x10\n\x08suffrage\x18\x03 \x01(\t\x12\x10\n\x08isLeader\x18\x04 \x01(\x08\x32\xbd\x0e\n\x07Seaweed\x12I\n\rSendHeartbeat\x12\x14.master_pb.Heartbeat\x1a\x1c.master_pb.HeartbeatResponse\"\x00(\x01\x30\x01\x12X\n\rKeepConnected\x12\x1f.master_pb.KeepConnectedRequest\x1a .master_pb.KeepConnectedResponse\"\x00(\x01\x30\x01\x12Q\n\x0cLookupVolume\x12\x1e.master_pb.LookupVolumeRequest\x1a\x1f.master_pb.LookupVolumeResponse\"\x00\x12?\n\x06\x41ssign\x12\x18.master_pb.AssignRequest\x1a\x19.master_pb.AssignResponse\"\x00\x12K\n\nStatistics\x12\x1c.master_pb.StatisticsRequest\x1a\x1d.master_pb.StatisticsResponse\"\x00\x12W\n\x0e\x43ollectionList\x12 .master_pb.CollectionListRequest\x1a!.master_pb.CollectionListResponse\"\x00\x12]\n\x10\x43ollectionDelete\x12\".master_pb.CollectionDeleteRequest\x1a#.master_pb.CollectionDeleteResponse\"\x00\x12K\n\nVolumeList\x12\x1c.master_pb.VolumeListRequest\x1a\x1d.master_pb.VolumeListResponse\"\x00\x12W\n\x0eLookupEcVolume\x12 .master_pb.LookupEcVolumeRequest\x1a!.master_pb.LookupEcVolumeResponse\"\x00\x12Q\n\x0cVacuumVolume\x12\x1e.master_pb.VacuumVolumeRequest\x1a\x1f.master_pb.VacuumVolumeResponse\"\x00\x12T\n\rDisableVacuum\x12\x1f.master_pb.DisableVacuumRequest\x1a .master_pb.DisableVacuumResponse\"\x00\x12Q\n\x0c\x45nableVacuum\x12\x1e.master_pb.EnableVacuumRequest\x1a\x1f.master_pb.EnableVacuumResponse\"\x00\x12\x63\n\x12VolumeMarkReadonly\x12$.master_pb.VolumeMarkReadonlyRequest\x1a%.master_pb.VolumeMarkReadonlyResponse\"\x00\x12o\n\x16GetMasterConfiguration\x12(.master_pb.GetMasterConfigurationRequest\x1a).master_pb.GetMasterConfigurationResponse\"\x00\x12Z\n\x0fLeaseAdminToken\x12!.master_pb.LeaseAdminTokenRequest\x1a\".master_pb.LeaseAdminTokenResponse\"\x00\x12`\n\x11ReleaseAdminToken\x12#.master_pb.ReleaseAdminTokenRequest\x1a$.master_pb.ReleaseAdminTokenResponse\"\x00\x12]\n\x10ListClusterNodes\x12\".master_pb.ListClusterNodesRequest\x1a#.master_pb.ListClusterNodesResponse\"\x00\x12\x39\n\x04Ping\x12\x16.master_pb.PingRequest\x1a\x17.master_pb.PingResponse\"\x00\x12o\n\x16RaftListClusterServers\x12(.master_pb.RaftListClusterServersRequest\x1a).master_pb.RaftListClusterServersResponse\"\x00\x12T\n\rRaftAddServer\x12\x1f.master_pb.RaftAddServerRequest\x1a .master_pb.RaftAddServerResponse\"\x00\x12]\n\x10RaftRemoveServer\x12\".master_pb.RaftRemoveServerRequest\x1a#.master_pb.RaftRemoveServerResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'master_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _HEARTBEAT_MAXVOLUMECOUNTSENTRY._options = None
  _HEARTBEAT_MAXVOLUMECOUNTSENTRY._serialized_options = b'8\001'
  _STORAGEBACKEND_PROPERTIESENTRY._options = None
  _STORAGEBACKEND_PROPERTIESENTRY._serialized_options = b'8\001'
  _DATANODEINFO_DISKINFOSENTRY._options = None
  _DATANODEINFO_DISKINFOSENTRY._serialized_options = b'8\001'
  _HEARTBEAT._serialized_start=28
  _HEARTBEAT._serialized_end=742
  _HEARTBEAT_MAXVOLUMECOUNTSENTRY._serialized_start=688
  _HEARTBEAT_MAXVOLUMECOUNTSENTRY._serialized_end=742
  _HEARTBEATRESPONSE._serialized_start=745
  _HEARTBEATRESPONSE._serialized_end=919
  _VOLUMEINFORMATIONMESSAGE._serialized_start=922
  _VOLUMEINFORMATIONMESSAGE._serialized_end=1270
  _VOLUMESHORTINFORMATIONMESSAGE._serialized_start=1273
  _VOLUMESHORTINFORMATIONMESSAGE._serialized_end=1412
  _VOLUMEECSHARDINFORMATIONMESSAGE._serialized_start=1414
  _VOLUMEECSHARDINFORMATIONMESSAGE._serialized_end=1521
  _STORAGEBACKEND._serialized_start=1524
  _STORAGEBACKEND._serialized_end=1680
  _STORAGEBACKEND_PROPERTIESENTRY._serialized_start=1631
  _STORAGEBACKEND_PROPERTIESENTRY._serialized_end=1680
  _KEEPCONNECTEDREQUEST._serialized_start=1682
  _KEEPCONNECTEDREQUEST._serialized_end=1787
  _VOLUMELOCATION._serialized_start=1790
  _VOLUMELOCATION._serialized_end=1981
  _CLUSTERNODEUPDATE._serialized_start=1983
  _CLUSTERNODEUPDATE._serialized_end=2094
  _KEEPCONNECTEDRESPONSE._serialized_start=2097
  _KEEPCONNECTEDRESPONSE._serialized_end=2231
  _LOOKUPVOLUMEREQUEST._serialized_start=2233
  _LOOKUPVOLUMEREQUEST._serialized_end=2302
  _LOOKUPVOLUMERESPONSE._serialized_start=2305
  _LOOKUPVOLUMERESPONSE._serialized_end=2522
  _LOOKUPVOLUMERESPONSE_VOLUMEIDLOCATION._serialized_start=2408
  _LOOKUPVOLUMERESPONSE_VOLUMEIDLOCATION._serialized_end=2522
  _LOCATION._serialized_start=2524
  _LOCATION._serialized_end=2607
  _ASSIGNREQUEST._serialized_start=2610
  _ASSIGNREQUEST._serialized_end=2830
  _ASSIGNRESPONSE._serialized_start=2833
  _ASSIGNRESPONSE._serialized_end=2984
  _STATISTICSREQUEST._serialized_start=2986
  _STATISTICSREQUEST._serialized_end=3078
  _STATISTICSRESPONSE._serialized_start=3080
  _STATISTICSRESPONSE._serialized_end=3159
  _COLLECTION._serialized_start=3161
  _COLLECTION._serialized_end=3187
  _COLLECTIONLISTREQUEST._serialized_start=3189
  _COLLECTIONLISTREQUEST._serialized_end=3272
  _COLLECTIONLISTRESPONSE._serialized_start=3274
  _COLLECTIONLISTRESPONSE._serialized_end=3342
  _COLLECTIONDELETEREQUEST._serialized_start=3344
  _COLLECTIONDELETEREQUEST._serialized_end=3383
  _COLLECTIONDELETERESPONSE._serialized_start=3385
  _COLLECTIONDELETERESPONSE._serialized_end=3411
  _DISKINFO._serialized_start=3414
  _DISKINFO._serialized_end=3698
  _DATANODEINFO._serialized_start=3701
  _DATANODEINFO._serialized_end=3877
  _DATANODEINFO_DISKINFOSENTRY._serialized_start=3808
  _DATANODEINFO_DISKINFOSENTRY._serialized_end=3877
  _RACKINFO._serialized_start=3879
  _RACKINFO._serialized_end=3951
  _DATACENTERINFO._serialized_start=3953
  _DATACENTERINFO._serialized_end=4022
  _TOPOLOGYINFO._serialized_start=4024
  _TOPOLOGYINFO._serialized_end=4104
  _VOLUMELISTREQUEST._serialized_start=4106
  _VOLUMELISTREQUEST._serialized_end=4125
  _VOLUMELISTRESPONSE._serialized_start=4127
  _VOLUMELISTRESPONSE._serialized_end=4225
  _LOOKUPECVOLUMEREQUEST._serialized_start=4227
  _LOOKUPECVOLUMEREQUEST._serialized_end=4269
  _LOOKUPECVOLUMERESPONSE._serialized_start=4272
  _LOOKUPECVOLUMERESPONSE._serialized_end=4475
  _LOOKUPECVOLUMERESPONSE_ECSHARDIDLOCATION._serialized_start=4398
  _LOOKUPECVOLUMERESPONSE_ECSHARDIDLOCATION._serialized_end=4475
  _VACUUMVOLUMEREQUEST._serialized_start=4477
  _VACUUMVOLUMEREQUEST._serialized_end=4564
  _VACUUMVOLUMERESPONSE._serialized_start=4566
  _VACUUMVOLUMERESPONSE._serialized_end=4588
  _DISABLEVACUUMREQUEST._serialized_start=4590
  _DISABLEVACUUMREQUEST._serialized_end=4612
  _DISABLEVACUUMRESPONSE._serialized_start=4614
  _DISABLEVACUUMRESPONSE._serialized_end=4637
  _ENABLEVACUUMREQUEST._serialized_start=4639
  _ENABLEVACUUMREQUEST._serialized_end=4660
  _ENABLEVACUUMRESPONSE._serialized_start=4662
  _ENABLEVACUUMRESPONSE._serialized_end=4684
  _VOLUMEMARKREADONLYREQUEST._serialized_start=4687
  _VOLUMEMARKREADONLYREQUEST._serialized_end=4876
  _VOLUMEMARKREADONLYRESPONSE._serialized_start=4878
  _VOLUMEMARKREADONLYRESPONSE._serialized_end=4906
  _GETMASTERCONFIGURATIONREQUEST._serialized_start=4908
  _GETMASTERCONFIGURATIONREQUEST._serialized_end=4939
  _GETMASTERCONFIGURATIONRESPONSE._serialized_start=4942
  _GETMASTERCONFIGURATIONRESPONSE._serialized_end=5190
  _LEASEADMINTOKENREQUEST._serialized_start=5193
  _LEASEADMINTOKENREQUEST._serialized_end=5326
  _LEASEADMINTOKENRESPONSE._serialized_start=5328
  _LEASEADMINTOKENRESPONSE._serialized_end=5388
  _RELEASEADMINTOKENREQUEST._serialized_start=5390
  _RELEASEADMINTOKENREQUEST._serialized_end=5487
  _RELEASEADMINTOKENRESPONSE._serialized_start=5489
  _RELEASEADMINTOKENRESPONSE._serialized_end=5516
  _LISTCLUSTERNODESREQUEST._serialized_start=5518
  _LISTCLUSTERNODESREQUEST._serialized_end=5585
  _LISTCLUSTERNODESRESPONSE._serialized_start=5588
  _LISTCLUSTERNODESRESPONSE._serialized_end=5812
  _LISTCLUSTERNODESRESPONSE_CLUSTERNODE._serialized_start=5688
  _LISTCLUSTERNODESRESPONSE_CLUSTERNODE._serialized_end=5812
  _PINGREQUEST._serialized_start=5814
  _PINGREQUEST._serialized_end=5864
  _PINGRESPONSE._serialized_start=5866
  _PINGRESPONSE._serialized_end=5949
  _RAFTADDSERVERREQUEST._serialized_start=5951
  _RAFTADDSERVERREQUEST._serialized_end=6017
  _RAFTADDSERVERRESPONSE._serialized_start=6019
  _RAFTADDSERVERRESPONSE._serialized_end=6042
  _RAFTREMOVESERVERREQUEST._serialized_start=6044
  _RAFTREMOVESERVERREQUEST._serialized_end=6096
  _RAFTREMOVESERVERRESPONSE._serialized_start=6098
  _RAFTREMOVESERVERRESPONSE._serialized_end=6124
  _RAFTLISTCLUSTERSERVERSREQUEST._serialized_start=6126
  _RAFTLISTCLUSTERSERVERSREQUEST._serialized_end=6157
  _RAFTLISTCLUSTERSERVERSRESPONSE._serialized_start=6160
  _RAFTLISTCLUSTERSERVERSRESPONSE._serialized_end=6358
  _RAFTLISTCLUSTERSERVERSRESPONSE_CLUSTERSERVERS._serialized_start=6277
  _RAFTLISTCLUSTERSERVERSRESPONSE_CLUSTERSERVERS._serialized_end=6358
  _SEAWEED._serialized_start=6361
  _SEAWEED._serialized_end=8214
# @@protoc_insertion_point(module_scope)
